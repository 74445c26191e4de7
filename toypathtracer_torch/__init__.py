"""toypathtracer_torch: the PyTorch/CUDA port of toypathtracer_tpu.

The same path tracer (46-sphere scene, Lambert/metal/dielectric, explicit
light sampling, XorShift32 RNG, thin-lens camera, progressive
accumulation, animation, Mray/s HUD) rendered on an NVIDIA H100 by a
hand-written CUDA kernel, with a plain PyTorch version of the same
function for the CPU.  It imports neither jax nor toypathtracer_tpu.

Layer map:
  ops/tracecore.py      plain PyTorch path-tracing math (lockstep lanes)
  ops/cuda_render.py    the render kernel's wrapper, pack_scene, launches
  ops/_build.py         nvcc build of csrc/ at first use, ctypes binding
  csrc/trace.cuh        the kernel's per-pixel code (also builds with g++)
  csrc/render.cu        the CUDA kernel and its launcher
  render/wavefront.py   render_frame_plain, the kernel's plain version
  render/frame.py       progressive accumulation and RenderSession
  cli.py                headless HUD CLI
  io.py                 sRGB + TGA/PNG output
"""

from .config import FLAG_ANIMATE, FLAG_PROGRESSIVE, RenderConfig
from .scene import Scene, make_scene

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Scene",
    "make_scene",
    "FLAG_ANIMATE",
    "FLAG_PROGRESSIVE",
]
