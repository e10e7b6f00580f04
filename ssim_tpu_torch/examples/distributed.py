"""Distributed SSIM over the ranks of a torchrun job (the counterpart of
examples/distributed.py): a batch of image pairs split over the ranks, and
one large image split by rows.

    torchrun --nproc-per-node=N -m ssim_tpu_torch.examples.distributed [--device cpu]

One GPU per rank (nccl), or `--device cpu` for gloo on the CPU.
"""

import argparse
import os
import sys

import numpy as np
import torch.distributed as dist

from ssim_tpu_torch import engine
from ssim_tpu_torch.parallel import (
    default_mesh, make_mesh, mean_ssim_sharded, multihost, ssim_batch_sharded,
    ssim_spatial_sharded,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Distributed SSIM over torchrun ranks.")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    multihost.initialize(device=args.device)
    n = dist.get_world_size()
    lead = dist.get_rank() == 0
    if lead:
        print(f"{n} ranks ({dist.get_backend()})")
    rng = np.random.default_rng(0)

    # 1) Batch data parallelism: one image pair per rank.
    mesh = default_mesh("data", n, device_type=args.device)
    a = rng.integers(0, 256, (n, 256, 384), dtype=np.uint8)
    b = np.clip(a + rng.normal(0, 10, a.shape).astype(np.int16), 0, 255).astype(np.uint8)
    partials, _ = ssim_batch_sharded(a, b, mesh)
    scores = engine.finalize_mean(partials.cpu().numpy(), 256 * 384)
    mean = float(mean_ssim_sharded(a, b, mesh))
    if lead:
        print("per-image SSIM (sharded):", np.round(scores, 4))
        print("mean via all-reduce:", mean)

    # 2) Spatial sharding: one large image, rows split across the ranks.
    mesh_s = make_mesh((n,), ("space",), device_type=args.device)
    big_a = rng.integers(0, 256, (n * 128, 1024), dtype=np.uint8)
    big_b = np.clip(big_a + rng.normal(0, 6, big_a.shape).astype(np.int16), 0, 255).astype(np.uint8)
    row_sums, _ = ssim_spatial_sharded(big_a, big_b, mesh_s)
    if lead:
        print("huge-image SSIM:",
              float(engine.finalize_mean(row_sums.cpu().numpy(), big_a.size)))


if __name__ == "__main__":
    main()
    # Every rank's collectives are done once all reach the barrier; exit
    # then, skipping the process group's teardown at interpreter exit (a
    # gloo rank aborted there once).
    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
