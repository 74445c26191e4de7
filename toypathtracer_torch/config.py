"""Render configuration (counterpart of toypathtracer_tpu/config.py).

The same fields and validation rules as the JAX package's `RenderConfig`,
so a configuration means the same render in both packages.  The TPU
tuning knobs (`tile_h`, `tile_w`, `pix_per_lane`, `grad_tile_*`,
`merged_wavefront`) never change the image, and the CUDA kernels run one
thread per pixel; only the stats render reads the first four of them, to
report the TPU kernel's per-tile occupancy counters
(ops/cuda_render.render_frame_stats).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

# Runtime flag bits (reference: Cpp/Source/Test.h:4-8).
FLAG_ANIMATE = 1 << 0
FLAG_PROGRESSIVE = 1 << 1

# The reference's float PI literal (Cpp/Source/Maths.h:9), kept identical
# for RNG/NEE parity.
KPI = 3.1415926


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration.

    Field origins in the reference:
      width/height            Config.h:6-7   (kBackbufferWidth/Height)
      samples_per_pixel       Config.h:22    (DO_SAMPLES_PER_PIXEL)
      animate_smoothing       Config.h:23    (DO_ANIMATE_SMOOTHING)
      do_light_sampling       Config.h:24    (DO_LIGHT_SAMPLING)
      do_mitsuba_compare      Config.h:25    (DO_MITSUBA_COMPARE)
      min_t/max_t/max_depth   Test.cpp:71-73 (kMinT/kMaxT/kMaxDepth)
    """

    width: int = 1280
    height: int = 720
    samples_per_pixel: int = 4
    max_depth: int = 10
    min_t: float = 0.001
    max_t: float = 1.0e7
    do_light_sampling: bool = True
    do_mitsuba_compare: bool = False
    animate_smoothing: float = 0.9

    # TPU tuning knobs of the JAX package: accepted so that configurations
    # move between the packages unchanged; the renders ignore them.
    tile_h: int = 16
    tile_w: int = 128
    pix_per_lane: int = 1
    grad_tile_h: int = 8
    grad_tile_w: int = 128
    merged_wavefront: bool = False
    diff_wavefront: bool = False
    soft_silhouette_eps: float = 0.0

    def __post_init__(self):
        # The same bounds as the JAX package (whose fused loop bit-packs
        # depth and sample counts into 8-bit fields), so that a config
        # valid in one package is valid in the other.
        if not (1 <= self.max_depth <= 255):
            raise ValueError(f"max_depth must be in [1, 255], "
                             f"got {self.max_depth}")
        if not (1 <= self.samples_per_pixel <= 255):
            raise ValueError(f"samples_per_pixel must be in [1, 255], "
                             f"got {self.samples_per_pixel}")
        if self.width < 1 or self.height < 1:
            raise ValueError(f"bad resolution {self.width}x{self.height}")
        if not (1 <= self.pix_per_lane <= 63):
            raise ValueError(f"pix_per_lane must be in [1, 63], "
                             f"got {self.pix_per_lane}")
        if self.diff_wavefront and not self.merged_wavefront:
            raise ValueError("diff_wavefront requires merged_wavefront "
                             "(the differentiable wavefront IS the merged "
                             "loop run reverse-mode)")
        if self.diff_wavefront and self.soft_silhouette_eps > 0.0:
            # as the JAX package: its merged differentiable loop
            # (tracecore.bounce_parts_merged) has no soft branch
            raise ValueError("diff_wavefront does not implement the "
                             "soft-silhouette estimator; use the lockstep "
                             "differentiable route for geometry recovery")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def inv_width(self) -> float:
        return 1.0 / self.width

    @property
    def inv_height(self) -> float:
        return 1.0 / self.height


def warn_diff_wavefront(cfg: RenderConfig):
    """Where cfg.diff_wavefront asks for the differentiable wavefront on a
    route that runs the lockstep differentiable form instead, say so, with
    the JAX package's words (ops/tracecore.py:2554-2568: a silently
    mislabeled A/B wastes the time it was run for).  The port falls back
    where the JAX package does: the exact-shadow samplers of the parity
    route (ops/tracecore.render_pixels_diff with CPU_SAMPLERS), the
    chunked scene (ops/cuda_scaled's gradient routes) and the in-kernel
    gradient route (K3's forms called as such, ops/cuda_grad.
    render_tile_grad_form; the JAX package's Pallas gradient kernel).  The
    flat scene's differentiable renders take the wavefront and do not
    warn."""
    if cfg.diff_wavefront:
        warnings.warn(
            "cfg.diff_wavefront ignored: exact-shadow samplers, chunked "
            "ports and the in-kernel (unrolled) gradient route use the "
            "lockstep differentiable form", stacklevel=3)


def resolve_device(device) -> torch.device:
    """The device an entry point renders on.  "cuda" without a card raises
    instead of silently rendering on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch finds no CUDA "
            "device; pass device='cpu' (on the command line: --device cpu) "
            "to render with the plain PyTorch renderer on the CPU")
    return dev
