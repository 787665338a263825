"""Rank program of ``tests/test_torch_tensor_parallel.py``: one of the four
ranks that ``autovc_tpu_torch.utils.launcher.launch_local_multiprocess``
starts (gloo, CPU), as a (2, 2) ``("data", "model")`` mesh.  It imports
nothing of JAX.

    python tests/torch_tp_worker.py <dir>

reads ``<dir>/inputs.pt`` (the global batches and full parameter trees
the test made) and runs, each from this rank's shards:

  * the column-parallel ``linear`` and ``conv1d``, the tensor-parallel
    LSTM stack (``lstm_stack_train(model=)``), BLSTM and GRU pair on this
    data index's rows: outputs and the gradients of sum(out * w), the
    sharded weights' gradients gathered whole;
  * one f32 step each of ``make_sharded_ae_step``,
    ``make_sharded_vocoder_step`` and ``make_sharded_se_step``
    (``with_grads``), the updated shards gathered whole;
  * ``train_autoencoder(mesh=)``, 2 steps, saving to ``<dir>/ckpt`` with
    a recording logger and an ``on_epoch_end`` hook;
  * ``train_speaker_encoder(mesh=)`` and ``train_vocoder(mesh=)``, one
    step each,

and writes what it got to ``<dir>/rank<r>.pt``.
"""
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dp_worker import ArrayDataset, ListLogger, flat  # noqa: E402


class BlockDataset:
    """A speaker-encoder dataset of one fixed (S, U, T, M) block."""

    def __init__(self, block):
        self.block = block

    def batches(self, utterances, n_batches, seed=0):
        for _ in range(n_batches):
            yield self.block


class VocoderDataset:
    """A vocoder dataset of one fixed (x_in, y, mels) batch."""

    def __init__(self, batch):
        self.batch = batch

    def batches(self, batch_size, seq_frames, n_batches, seed=0):
        for _ in range(n_batches):
            yield self.batch


def main(d):
    from autovc_tpu_torch.config import (AutoEncoderConfig,
                                         SpeakerEncoderConfig,
                                         WaveRNNConfig)
    from autovc_tpu_torch.ops import conv as C
    from autovc_tpu_torch.ops import gru_train_kernels as GT
    from autovc_tpu_torch.ops import lstm_train_kernels as LT
    from autovc_tpu_torch.ops import rnn as R
    from autovc_tpu_torch.parallel import collectives as COL
    from autovc_tpu_torch.parallel import sharding as shd
    from autovc_tpu_torch.parallel import steps as psteps
    from autovc_tpu_torch.parallel import tensor as TP
    from autovc_tpu_torch.train import loop as L
    from autovc_tpu_torch.train import schedules as TS
    from autovc_tpu_torch.utils import tree_clone, tree_leaves, tree_unflatten

    torch.set_num_threads(1)
    psteps.initialize_distributed()
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    mesh = shd.make_mesh((2, 2), ("data", "model"))
    r = mesh.rank
    out = {"rank": r, "shape": mesh.shape,
           "groups": [dist.get_process_group_ranks(g)
                      for g in (mesh.data_group, mesh.model_group)],
           "foreign": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib",
                                                    "autovc_tpu"))}

    def mine(a):
        return psteps.shard_batch(a, mesh)

    def sharded(tree):
        """This rank's shards of a full tree, the model axis over them
        and a gather of a tree of their structure."""
        specs = shd.param_shardings(tree, mesh)
        local = shd.shard_params(tree_clone(tree), mesh)[0]
        return (local, TP.model_axis(mesh, local, specs),
                lambda t: shd.gather_params(t, specs, mesh))

    # the column-parallel ops and recurrences: outputs and gradients,
    # the weights' summed over the data group and gathered whole
    def gru(p, x, m):
        xc = TP.copy_to_model(x.transpose(0, 1), m)
        xp1 = torch.matmul(xc, p[0]["w_ih"]) + p[0]["b_ih"]
        base2 = p[1]["b_ih"].expand(xp1.shape)
        return torch.stack(GT.gru_pair(
            xp1, base2, p[1]["w_ih"], p[0]["w_hh"], p[0]["b_hh"],
            p[1]["w_hh"], p[1]["b_hh"], "f32", m)).permute(2, 0, 1, 3)

    runs = {
        "linear": lambda p, x, m: C.linear(p["proj"], x, "f32", m),
        "conv1d": lambda p, x, m: C.conv1d(p["convs"][0]["conv"], x, 2,
                                           "f32", m),
        "lstm": lambda p, x, m: LT.lstm_stack_train(p, x, "f32", m)[0],
        "blstm": lambda p, x, m: R.bilstm_stack(p, x, "f32", m),
        "gru": gru,
    }
    results = {}
    for name, fn in runs.items():
        full = inp["ops"][name]
        local, model, gather = sharded(full["params"])
        leaves = tree_leaves(local)
        x = mine(full["x"]).clone().requires_grad_(True)
        for leaf in leaves:
            leaf.requires_grad_(True)
        y = fn(local, x, model)
        gx, *gw = torch.autograd.grad(torch.sum(y * mine(full["w"])),
                                      [x] + leaves)
        COL.all_reduce_flat(gw, mesh.data_group)
        results[name] = {"y": y.detach(), "gx": gx,
                         "gw": flat(tree_leaves(gather(
                             tree_unflatten(local, gw))))}
    out["ops"] = results

    def adam():
        return TS.Optimizer(lambda count: inp["lr"], 0.9, 0.999, 1e-8, 1.0)

    # the generator
    ae = inp["ae"]
    cfg = AutoEncoderConfig().with_overrides(**ae["cfg"])
    params, _, gather = sharded(ae["params"])
    tx = adam()
    step = psteps.make_sharded_ae_step(cfg, tx, 0.999, mesh,
                                       precision="f32", with_grads=True)
    state = tx.init(tree_leaves(params))
    params, state, ema, aux = step(params, state, tree_clone(params),
                                   mine(ae["x"]), mine(ae["c"]))
    out["ae"] = {"aux": {k: float(v) for k, v in aux.items()
                         if k != "grads"},
                 "grads": flat(tree_leaves(aux["grads"])),
                 "params": flat(tree_leaves(gather(params))),
                 "ema": flat(tree_leaves(gather(ema)))}

    # the vocoder
    voc = inp["voc"]
    wcfg = WaveRNNConfig().with_overrides(**voc["cfg"])
    params, _, gather = sharded(voc["params"])
    tx = adam()
    step = psteps.make_sharded_vocoder_step(wcfg, tx, mesh, precision="f32",
                                            with_grads=True)
    params, _, aux = step(params, tx.init(tree_leaves(params)),
                          mine(voc["x_in"]), mine(voc["y"]),
                          mine(voc["mels"]))
    out["voc"] = {"loss": float(aux["loss"]),
                  "grad_norm": float(aux["grad_norm"]),
                  "grads": flat(tree_leaves(aux["grads"])),
                  "params": flat(tree_leaves(gather(params)))}

    # the speaker encoder (GE2E over the data group's gathered embeddings)
    se = inp["se"]
    scfg = SpeakerEncoderConfig()
    params, _, gather = sharded(se["params"])
    tx = adam()
    step = psteps.make_sharded_se_step(scfg, tx, mesh, precision="f32",
                                       with_grads=True)
    params, _, aux = step(params, tx.init(tree_leaves(params)),
                          mine(se["block"]))
    out["se"] = {"loss": float(aux["loss"]),
                 "grad_norm": float(aux["grad_norm"]),
                 "grads": flat(tree_leaves(aux["grads"])),
                 "params": flat(tree_leaves(gather(params)))}

    # the generator's loop: rank 0 writes one full tree
    lp = inp["loop"]
    logger, epochs = ListLogger(), []
    params, ema, info = L.train_autoencoder(
        tree_clone(lp["params"]), ArrayDataset(lp["x"], lp["c"]), cfg,
        n_epochs=1, batch_size=lp["batch_size"], log_freq=1, save_freq=1,
        model_name="tp", save_dir=os.path.join(d, "ckpt"), logger=logger,
        verbose=False, on_epoch_end=lambda e, p: epochs.append(
            [tuple(t.shape) for t in tree_leaves(p)]),
        opt_overrides={"lr": lp["lr"]}, precision="f32", mesh=mesh)
    out["loop"] = {"params": flat(tree_leaves(params)),
                   "mu": flat(info["opt_state"]["mu"]),
                   "step": info["step"], "records": logger.records,
                   "epochs": epochs}

    # one step of each other loop on the mesh
    params, info = L.train_speaker_encoder(
        tree_clone(se["params"]), BlockDataset(se["block"]), scfg,
        n_epochs=1, steps_per_epoch=1, model_name="", verbose=False,
        mesh=mesh)
    out["se_loop"] = {"params": flat(tree_leaves(params)),
                      "step": info["step"]}
    params, info = L.train_vocoder(
        tree_clone(voc["params"]), VocoderDataset(
            (voc["x_in"], voc["y"], voc["mels"])), wcfg, n_epochs=1,
        steps_per_epoch=1, batch_size=4, lr=inp["lr"], model_name="",
        verbose=False, mesh=mesh)
    out["voc_loop"] = {"params": flat(tree_leaves(params)),
                       "step": info["step"]}
    torch.save(out, os.path.join(d, f"rank{r}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
