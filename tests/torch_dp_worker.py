"""Rank program of ``tests/test_torch_parallel_dp.py``: one of the ranks
that ``autovc_tpu_torch.utils.launcher.launch_local_multiprocess`` starts
(gloo, CPU).  It imports nothing of JAX.

    python tests/torch_dp_worker.py <dir>

reads ``<dir>/inputs.pt`` (the global batches and parameters the test
made), runs on this rank's rows, each from a copy of the parameters (the
steps update them in place)

  * sync BatchNorm (``conv.batchnorm1d(group=)``): output, running
    statistics and gradients of sum(out * w);
  * one f32 step each of ``make_sharded_ae_step``,
    ``make_sharded_vocoder_step`` and ``make_sharded_se_step``
    (``with_grads``);
  * ``train_autoencoder(mesh=)``, 2 steps, saving to ``<dir>/ckpt`` with
    a recording logger and an ``on_epoch_end`` hook,

and writes what it got to ``<dir>/rank<r>.pt``.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


class ListLogger:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append(dict(metrics))


class ArrayDataset:
    """An AutoVC dataset of fixed arrays: each epoch's batches in a
    seeded order."""

    def __init__(self, x, c):
        self.x, self.c = x, c

    def epoch_steps(self, batch_size):
        return len(self.x) // batch_size

    def batches(self, batch_size, shuffle=True, seed=0):
        order = np.random.default_rng(seed).permutation(len(self.x))
        for i in range(self.epoch_steps(batch_size)):
            sel = order[i * batch_size:(i + 1) * batch_size]
            yield self.x[sel], self.c[sel]


def flat(tensors):
    return [t.detach().clone() for t in tensors]


def main(d):
    from autovc_tpu_torch.config import (AutoEncoderConfig,
                                         SpeakerEncoderConfig,
                                         WaveRNNConfig)
    from autovc_tpu_torch.ops import conv as C
    from autovc_tpu_torch.parallel import collectives as COL
    from autovc_tpu_torch.parallel import sharding as shd
    from autovc_tpu_torch.parallel import steps as psteps
    from autovc_tpu_torch.train import loop as L
    from autovc_tpu_torch.train import schedules as TS
    from autovc_tpu_torch.utils import tree_clone, tree_leaves

    torch.set_num_threads(1)
    device = psteps.initialize_distributed()
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    mesh = shd.make_mesh()
    r, n = mesh.rank, mesh.size
    out = {"rank": r, "world": n, "device": str(device),
           "mesh_devices": [str(x) for x in mesh.devices],
           "foreign": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib",
                                                    "autovc_tpu"))}

    def mine(a):
        return psteps.shard_batch(a, mesh)

    # sync BatchNorm: forward, running statistics, gradients
    bn = inp["bn"]
    p = {k: bn[k].clone() for k in ("scale", "bias", "mean", "var")}
    x = mine(bn["x"]).clone().requires_grad_(True)
    p["scale"].requires_grad_(True)
    p["bias"].requires_grad_(True)
    y = C.batchnorm1d(p, x, train=True, group=dist.group.WORLD)
    gx, gs, gb = torch.autograd.grad(torch.sum(y * mine(bn["w"])),
                                     [x, p["scale"], p["bias"]])
    COL.all_reduce_flat([gs, gb])
    out["bn"] = {"y": y.detach(), "gx": gx, "gs": gs, "gb": gb,
                 "mean": p["mean"].detach(), "var": p["var"].detach()}

    def adam():
        return TS.Optimizer(lambda count: inp["lr"], 0.9, 0.999, 1e-8, 1.0)

    # the generator
    ae = inp["ae"]
    cfg = AutoEncoderConfig().with_overrides(**ae["cfg"])
    params = shd.shard_params(tree_clone(ae["params"]), mesh)[0]
    tx = adam()
    step = psteps.make_sharded_ae_step(cfg, tx, 0.999, mesh,
                                       precision="f32", with_grads=True)
    state = tx.init(tree_leaves(params))
    params, state, ema, aux = step(params, state, tree_clone(params),
                                   mine(ae["x"]), mine(ae["c"]))
    out["ae"] = {"aux": {k: float(v) for k, v in aux.items()
                         if k != "grads"},
                 "grads": flat(tree_leaves(aux["grads"])),
                 "params": flat(tree_leaves(params)),
                 "ema": flat(tree_leaves(ema))}

    # the vocoder
    voc = inp["voc"]
    wcfg = WaveRNNConfig().with_overrides(**voc["cfg"])
    params = shd.shard_params(tree_clone(voc["params"]), mesh)[0]
    tx = adam()
    step = psteps.make_sharded_vocoder_step(wcfg, tx, mesh, precision="f32",
                                            with_grads=True)
    params, _, aux = step(params, tx.init(tree_leaves(params)),
                          mine(voc["x_in"]), mine(voc["y"]),
                          mine(voc["mels"]))
    out["voc"] = {"loss": float(aux["loss"]),
                  "grad_norm": float(aux["grad_norm"]),
                  "grads": flat(tree_leaves(aux["grads"])),
                  "params": flat(tree_leaves(params))}

    # the speaker encoder (GE2E over the gathered embeddings)
    se = inp["se"]
    scfg = SpeakerEncoderConfig()
    params = shd.shard_params(tree_clone(se["params"]), mesh)[0]
    tx = adam()
    step = psteps.make_sharded_se_step(scfg, tx, mesh, precision="f32",
                                       with_grads=True)
    params, _, aux = step(params, tx.init(tree_leaves(params)),
                          mine(se["block"]))
    out["se"] = {"loss": float(aux["loss"]),
                 "grad_norm": float(aux["grad_norm"]),
                 "grads": flat(tree_leaves(aux["grads"])),
                 "params": flat(tree_leaves(params))}

    # the data-parallel training loop
    lp = inp["loop"]
    logger, epochs = ListLogger(), []
    params, ema, info = L.train_autoencoder(
        tree_clone(lp["params"]), ArrayDataset(lp["x"], lp["c"]), cfg, n_epochs=1,
        batch_size=lp["batch_size"], log_freq=1, save_freq=1,
        model_name="dp", save_dir=os.path.join(d, "ckpt"), logger=logger,
        verbose=False, on_epoch_end=lambda e, p: epochs.append(e),
        opt_overrides={"lr": lp["lr"]}, precision="f32", mesh=mesh)
    out["loop"] = {"params": flat(tree_leaves(params)),
                   "step": info["step"], "records": logger.records,
                   "epochs": epochs}
    torch.save(out, os.path.join(d, f"rank{r}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
