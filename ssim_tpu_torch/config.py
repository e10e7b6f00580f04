"""Runtime configuration.

Counterpart of `ssim_tpu/config.py`: the same `Config` dataclass and
environment variables, with the port's prefix. The JAX package's
`enable_compile_cache` has no counterpart (PyTorch runs eagerly; the CUDA
kernel's build is cached by source hash in `ops/_build.py`).

| ssim_tpu              | ssim_tpu_torch                     |
|-----------------------|------------------------------------|
| SSIM_TPU_IMPL         | SSIM_TPU_TORCH_IMPL                |
| SSIM_TPU_PRECISION    | SSIM_TPU_TORCH_PRECISION           |
| SSIM_TPU_TILE_H / _W  | SSIM_TPU_TORCH_TILE_H / _W (CUDA kernel tile) |
"""

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Config:
    """Process-wide defaults, overridable per-call via API kwargs."""

    #: Default implementation ("auto", "torch", "cuda", "reference").
    impl: str = "auto"
    #: Default pixel precision ("f32" or "f64").
    precision: str = "f32"
    #: Pin the CUDA kernel's output tile (None = ops.ssim_cuda.TILE_H x
    #: TILE_W). Any value >= 1: engine.compute clamps it into the range the
    #: kernel takes (ops.ssim_cuda.fit_tile), and a pin keeps batches of
    #: small images on the tile grid.
    max_tile_h: Optional[int] = None
    max_tile_w: Optional[int] = None

    @classmethod
    def from_env(cls) -> "Config":
        def _int(name):
            v = os.environ.get(name)
            return int(v) if v else None

        return cls(
            impl=os.environ.get("SSIM_TPU_TORCH_IMPL", "auto"),
            precision=os.environ.get("SSIM_TPU_TORCH_PRECISION", "f32"),
            max_tile_h=_int("SSIM_TPU_TORCH_TILE_H"),
            max_tile_w=_int("SSIM_TPU_TORCH_TILE_W"),
        )


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def set_config(cfg: Config) -> None:
    global _config
    _config = cfg
