"""Design studies of the port's kernels, run on the CPU through the plain
twins' building blocks (`python -m ssim_tpu_torch.tools.<name>`)."""
