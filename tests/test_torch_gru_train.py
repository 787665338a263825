"""CPU parity of the port's GRU-pair training path
(``autovc_tpu_torch/ops/gru_train_kernels.py``: the plain versions of
kernels 4 and 5 behind ``GruPair``) against the JAX training kernels
(``autovc_tpu/ops/gru_train_pallas.py``) in interpret mode and the JAX
scan (``ops/rnn._gru_core``): both outputs and all seven gradients, f32 at
the JAX test's shapes and bars (forward 1e-5, gradients rtol/atol 2e-4),
bf16 at H=256 (relative 2e-2 of max |ref|: both sides round the same
operands and saved activations to bf16 but sum in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.ops import gru_train_pallas as JGP
from autovc_tpu.ops import precision as JPREC
from autovc_tpu.ops import rnn as JR
from autovc_tpu_torch.ops import gru_train_kernels as GT
from autovc_tpu_torch.ops import precision as PREC

NAMES = ["dxp1", "dbase2", "dwih2x", "dwhh1", "dbhh1", "dwhh2", "dbhh2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(B, T, H, seed=0):
    """xp1, base2 (T, B, 3H), wih2x, whh1 (H, 3H), bhh1, whh2, bhh2: the
    JAX ``gru_pair`` argument order."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return (0.4 * rng.standard_normal(s)).astype(np.float32)

    return (f(T, B, 3 * H), f(T, B, 3 * H), f(H, 3 * H), f(H, 3 * H),
            f(3 * H), f(H, 3 * H), f(3 * H))


def _scan_pair(xp1, base2, wih2x, whh1, bhh1, whh2, bhh2):
    """The JAX scan reference (``_gru_core`` twice, the same contract)."""
    B = xp1.shape[1]
    h1s, _ = JR._gru_core(xp1, whh1, bhh1,
                          jnp.zeros((B, whh1.shape[0]), xp1.dtype))
    xp2 = base2 + jnp.matmul(h1s, wih2x, precision=jax.lax.Precision.HIGHEST)
    h2s, _ = JR._gru_core(xp2, whh2, bhh2,
                          jnp.zeros((B, whh2.shape[0]), xp1.dtype))
    return h1s, h2s


def _loss_jax(pair):
    def loss(*a):
        h1, h2 = pair(*a)
        return jnp.sum(jnp.sin(h2)) + 0.5 * jnp.sum(jnp.cos(h1))
    return loss


def _jax_grads(pair, args):
    return jax.value_and_grad(_loss_jax(pair), argnums=tuple(range(7)))(
        *map(jnp.asarray, args))


def _torch_grads(args, mode):
    ta = [torch.from_numpy(a).requires_grad_(True) for a in args]
    h1, h2 = GT.gru_pair(*ta, mode=mode)
    loss = torch.sum(torch.sin(h2)) + 0.5 * torch.sum(torch.cos(h1))
    loss.backward()
    return (h1.detach().numpy(), h2.detach().numpy()), float(loss.detach()), \
        [t.grad.numpy() for t in ta]


@pytest.mark.parametrize("B,T,H", [(2, 17, 8), (5, 13, 8), (1, 40, 16)])
def test_pair_matches_pallas_and_scan(B, T, H):
    """Values against the JAX kernel (interpret mode) and the scan at 1e-5;
    the loss and all seven gradients against both at rtol/atol 2e-4."""
    args = _setup(B, T, H, seed=B)
    (h1, h2), loss, grads = _torch_grads(args, "f32")
    pallas = lambda *a: JGP.gru_pair(*a, interpret=True)   # noqa: E731
    for pair in (pallas, _scan_pair):
        r1, r2 = pair(*map(jnp.asarray, args))
        for a, b in ((h1, r1), (h2, r2)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
        ref_loss, ref_grads = _jax_grads(pair, args)
        np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
        for n, a, b in zip(NAMES, grads, ref_grads):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4,
                                       atol=2e-4, err_msg=n)


def test_bf16_matches_pallas_bf16():
    """H=256 and 2 rows: the scan's gate gives bf16, as the JAX kernel
    runs under the bf16 policy."""
    args = _setup(2, 12, 256, seed=7)
    (h1, h2), _, grads = _torch_grads(args, "bf16")
    with JPREC.compute("bf16"):
        pallas = lambda *a: JGP.gru_pair(*a, interpret=True)   # noqa: E731
        r1, r2 = pallas(*map(jnp.asarray, args))
        _, ref_grads = _jax_grads(pallas, args)
    for n, a, b in zip(["h1", "h2"] + NAMES, [h1, h2] + grads,
                       [r1, r2] + list(ref_grads)):
        b = np.asarray(b, np.float32)
        err = np.abs(a - b).max()
        assert err <= 2e-2 * np.abs(b).max(), (n, err, np.abs(b).max())


def test_compute_dtype_follows_the_scan_gate():
    """bf16 only under the bf16 policy with H >= 256 and >= 2 rows."""
    assert PREC.rec_dtype("bf16", 2, 256) == torch.bfloat16
    for args in (("bf16", 1, 512), ("bf16", 8, 128), ("f32", 8, 512)):
        assert PREC.rec_dtype(*args) == torch.float32


def test_plain_backward_is_autograd_of_plain_forward():
    """The explicit backward (kernel 5's oracle) against torch.autograd
    through the plain forward, f32, with cotangents on h1 and h2."""
    B, T, H = 3, 11, 16
    gen = torch.Generator().manual_seed(3)
    xp1 = torch.randn(T, B, 3 * H, generator=gen, requires_grad=True)
    base2 = torch.randn(T, B, 3 * H, generator=gen, requires_grad=True)
    ws = [(0.3 * torch.randn(H, 3 * H, generator=gen)).requires_grad_()
          for _ in range(3)]                       # whh1, wih2x, whh2
    bs = [(0.1 * torch.randn(3 * H, generator=gen)).requires_grad_()
          for _ in range(2)]
    hs, acts = GT.gru_pair_fwd_plain(
        xp1, base2, *GT.pack_fwd(*ws, torch.float32), *bs)
    dh1s = torch.randn(T, B, H, generator=gen)
    dh2s = torch.randn(T, B, H, generator=gen)
    ref = torch.autograd.grad((hs[0], hs[1]),
                              (xp1, base2, ws[1], ws[0], bs[0], ws[2], bs[1]),
                              (dh1s, dh2s))
    got = GT.gru_pair_bwd_plain(
        acts.detach(), hs.detach(), dh1s, dh2s,
        *GT.pack_bwd(*(w.detach() for w in ws), torch.float32))
    for n, a, b in zip(NAMES, got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=n)


def test_launch_checks_geometry():
    """The kernels take H % 16 == 0; another H raises with the reason
    before anything reaches the card."""
    args = [torch.from_numpy(a) for a in _setup(2, 3, 8)]
    wf = GT.pack_fwd(args[3], args[2], args[5], torch.float32)
    with pytest.raises(ValueError, match="H % 16"):
        GT.fwd_launch(args[0], args[1], *wf, args[4], args[6])
