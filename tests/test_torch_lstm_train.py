"""CPU parity of the port's LSTM-stack training path
(``autovc_tpu_torch/ops/lstm_train_kernels.py``: the plain versions of
kernels 6 and 7 behind ``StackTrain``) against the JAX training kernels
(``autovc_tpu/ops/lstm_train_pallas.py``) in interpret mode: outputs, final
states and every gradient, f32 at the JAX test's shapes (rtol/atol 3e-4,
the JAX test's own bar for its kernel against its scan) and bf16 at H=256
(relative 2e-2 of max |ref|: both sides round the same operands to bf16,
and the saved activations too, but sum in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.ops import lstm_train_pallas as JLT
from autovc_tpu.ops import precision as JPREC
from autovc_tpu.ops import rnn as JR
from autovc_tpu_torch.ops import lstm_train_kernels as LT
from autovc_tpu_torch.utils.bridge import from_jax_params


def _setup(L, B, T, I, H, seed=0):
    params = JR.init_lstm_stack(jax.random.PRNGKey(seed), I, H, L)
    rng = np.random.default_rng(seed + 1)
    x = (0.5 * rng.standard_normal((B, T, I))).astype(np.float32)
    return params, x


def _torch_params(jp):
    return [{k: v.requires_grad_(True) for k, v in p.items()}
            for p in from_jax_params(jp)]


def _loss_jax(p, x, interpret=True):
    ys, (h, c) = JLT.lstm_stack_train(p, x, interpret=interpret)
    return (jnp.sum(jnp.sin(ys)) + 2.0 * jnp.sum(h * h)
            + 0.5 * jnp.sum(c * c))


def _loss_torch(p, x, mode):
    ys, (h, c) = LT.lstm_stack_train(p, x, mode)
    return (torch.sum(torch.sin(ys)) + 2.0 * torch.sum(h * h)
            + 0.5 * torch.sum(c * c))


def _grads_torch(jp, x, mode):
    tp = _torch_params(jp)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = _loss_torch(tp, xt, mode)
    loss.backward()
    # the JAX leaf order: layers in order, dict keys sorted
    leaves = [p[k].grad for p in tp for k in sorted(p)]
    return float(loss.detach()), leaves, xt.grad


@pytest.mark.parametrize("L,B,T,I,H", [(1, 2, 11, 6, 8),
                                       (2, 3, 24, 10, 8),
                                       (3, 5, 17, 4, 16)])
def test_forward_matches_pallas(L, B, T, I, H):
    jp, x = _setup(L, B, T, I, H, seed=L)
    ys_ref, (h_ref, c_ref) = JLT.lstm_stack_train(jp, jnp.asarray(x),
                                                  interpret=True)
    with torch.no_grad():
        ys, (h, c) = LT.lstm_stack_train(from_jax_params(jp),
                                         torch.from_numpy(x), "f32")
    for a, b in ((ys, ys_ref), (h, h_ref), (c, c_ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4,
                                   atol=3e-4)


@pytest.mark.parametrize("L,B,T,I,H", [(2, 3, 13, 6, 8), (3, 2, 20, 5, 8),
                                       (1, 2, 9, 5, 8)])
def test_grads_match_pallas(L, B, T, I, H):
    """Cotangents through ys, h_fin AND c_fin; gradients of x and of every
    layer's w_ih, w_hh, b_ih, b_hh (layer 0's biases through the hoisted
    projection, the others through the backward's db)."""
    jp, x = _setup(L, B, T, I, H, seed=10 + L)
    ref_loss, (gp, gx) = jax.value_and_grad(_loss_jax, argnums=(0, 1))(
        jp, jnp.asarray(x))
    loss, leaves, xg = _grads_torch(jp, x, "f32")
    np.testing.assert_allclose(loss, float(ref_loss), rtol=3e-4)
    for a, b in zip(leaves + [xg], jax.tree_util.tree_leaves(gp) + [gx]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4,
                                   atol=3e-4)


def test_bf16_matches_pallas_bf16():
    """H=256: the compute dtype is bf16 on both sides."""
    jp, x = _setup(2, 3, 6, 16, 256, seed=7)
    with JPREC.compute("bf16"):
        (ys_ref, (h_ref, _)) = JLT.lstm_stack_train(jp, jnp.asarray(x),
                                                    interpret=True)
        _, (gp, gx) = jax.value_and_grad(_loss_jax, argnums=(0, 1))(
            jp, jnp.asarray(x))
    with torch.no_grad():
        ys, (h, _) = LT.lstm_stack_train(from_jax_params(jp),
                                         torch.from_numpy(x), "bf16")
    _, leaves, xg = _grads_torch(jp, x, "bf16")
    pairs = [(ys, ys_ref), (h, h_ref)] + list(
        zip(leaves + [xg], jax.tree_util.tree_leaves(gp) + [gx]))
    for a, b in pairs:
        b = np.asarray(b, np.float32)
        err = np.abs(a.detach().numpy() - b).max()
        assert err <= 2e-2 * np.abs(b).max(), (err, np.abs(b).max())


def test_plain_backward_is_autograd_of_plain_forward():
    """The explicit backward (kernel 7's oracle) against torch.autograd
    through the plain forward, f32, with cotangents on all three
    outputs."""
    L, B, T, I, H = 3, 4, 9, 5, 16
    gen = torch.Generator().manual_seed(3)
    xp0 = torch.randn(T, B, 4 * H, generator=gen, requires_grad=True)
    whh = (0.3 * torch.randn(L, H, 4 * H, generator=gen)).requires_grad_()
    wih = (0.3 * torch.randn(L - 1, H, 4 * H, generator=gen)).requires_grad_()
    bias = (0.1 * torch.randn(L - 1, 4 * H, generator=gen)).requires_grad_()
    ys, h_fin, c_fin, hs, cs, acts = LT.lstm_train_fwd_plain(
        xp0, *LT.pack_fwd(whh, wih, torch.float32), bias)
    dys = torch.randn(T, B, H, generator=gen)
    dh_fin = torch.randn(B, H, generator=gen)
    dc_fin = torch.randn(B, H, generator=gen)
    ref = torch.autograd.grad((ys, h_fin, c_fin), (xp0, whh, wih, bias),
                              (dys, dh_fin, dc_fin))
    dxp0, dwhh, dwih, db = LT.lstm_train_bwd_plain(
        acts.detach(), hs.detach(), cs.detach(), dys, dh_fin, dc_fin,
        *LT.pack_bwd(whh.detach(), wih.detach(), torch.float32))
    for a, b in zip((dxp0, dwhh, dwih, db[1:]), ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
