"""Multi-process smoke run: each process joins the process group (the
environment ``utils.launcher.launch_local_multiprocess`` sets), builds the
mesh over every rank and runs one data-parallel AutoVC train step on a
small seeded global batch (T = 32 frames, 2 rows a rank).

    python -m autovc_tpu_torch.parallel.multihost_smoke

under the launcher.  Rank 0 prints ``MULTIHOST_OK loss=<x> procs=<n>
devices=<m> device=<its device> backend=<gloo or nccl>``.
"""
from __future__ import annotations


def main() -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from autovc_tpu_torch.config import AutoEncoderConfig
    from autovc_tpu_torch.models import autoencoder as AE
    from autovc_tpu_torch.parallel import sharding as shd
    from autovc_tpu_torch.parallel import steps as psteps
    from autovc_tpu_torch.train import schedules
    from autovc_tpu_torch.utils import tree_clone, tree_leaves

    device = psteps.initialize_distributed()
    try:
        cfg = AutoEncoderConfig().with_overrides(
            spectrogram={"partial_utterance_n_frames": 32})
        params = AE.init(torch.Generator().manual_seed(0), cfg)
        tx = schedules.make_optimizer(cfg.optimizer, steps_per_epoch=1)
        mesh = shd.make_mesh()
        n = mesh.shape["data"]
        B = 2 * n
        rng = np.random.default_rng(0)
        x = rng.random((B, 80, 32), dtype=np.float32)
        c = rng.standard_normal((B, 256)).astype(np.float32)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        params = shd.shard_params(params, mesh)[0]
        step = psteps.make_sharded_ae_step(cfg, tx, 0.9999, mesh,
                                           precision="f32")
        _, _, _, aux = step(params, tx.init(tree_leaves(params)),
                            tree_clone(params),
                            psteps.shard_batch(x, mesh),
                            psteps.shard_batch(c, mesh))
        loss = float(aux["loss"])
        if mesh.rank == 0:
            print(f"MULTIHOST_OK loss={loss:.4f} procs="
                  f"{dist.get_world_size()} devices={mesh.size} "
                  f"device={device} backend={dist.get_backend()}",
                  flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
