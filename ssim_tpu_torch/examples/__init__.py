"""Runnable examples of the port, the counterparts of the repo's
`examples/*.py`:

    python -m ssim_tpu_torch.examples.sample a.png b.png
    python -m ssim_tpu_torch.examples.training [--steps N]
    torchrun --nproc-per-node=N -m ssim_tpu_torch.examples.distributed

Each runs on the GPU unless given `--device cpu`, and raises without one.
"""
