"""toypathtracer_torch: the PyTorch/CUDA port of toypathtracer_tpu.

The same path tracer (46-sphere and 100k-sphere scenes, Lambert/metal/
dielectric, explicit light sampling, XorShift32 RNG, thin-lens camera,
progressive accumulation, animation, Mray/s HUD) and its inverse
rendering (scene gradients, Adam) on an NVIDIA H100 through hand-written
CUDA kernels, with a plain PyTorch version of each for the CPU.  It imports neither jax
nor toypathtracer_tpu.

Layer map:
  inverse.py            InverseRenderer, losses, Adam (the training step),
                        make_sharded_value_and_grad (row-sharded)
  demo_inverse.py       albedo-recovery demo (python -m ...demo_inverse)
  ops/tracecore.py      plain PyTorch path-tracing math (lockstep lanes),
                        differentiable with autograd; its CPU-exact
                        parity route (CPU_SAMPLERS, trace_cpu_exact)
  ops/libm.py           the C library's sinf/cosf for the parity route
                        (csrc/libm.cpp, built with g++)
  ops/cuda_render.py    the render kernel's wrapper, pack_scene, launches
  ops/cuda_grad.py      the gradient and lockstep kernels' wrappers and the
                        autograd Function of the training step
  ops/cuda_scaled.py    the scaled scene's kernel wrappers: chunk traversal
                        (hit_chunks), shadow bitmask, scaled render (also
                        row-sharded)
  scaled.py             the 100k-sphere chunked scene, its plain traversal
                        and plain render
  ops/_build.py         nvcc build of csrc/ at first use, ctypes binding
  csrc/trace.cuh        the kernels' per-pixel code and its hand-written
                        adjoint (also builds with g++)
  csrc/gradwarp.cuh     the gradient kernel's per-warp code (also with g++)
  csrc/warp.cuh         the warp policies of the warp-level code
  csrc/render.cu        the render kernel and its launcher
  csrc/grad.cu          the gradient and lockstep kernels and launchers
  csrc/chunks.cuh       the per-ray chunk traversal (also builds with g++)
  csrc/scaled.cu        the traversal, shadow and scaled render kernels
  render/wavefront.py   the kernels' plain versions
  render/frame.py       progressive accumulation and RenderSession
  render/parity.py      the reference's scalar C++ semantics (validation
                        against its goldens, tests/golden)
  parallel/mesh.py      row-sharded frames over a RowMesh of devices (the
                        bands on each device's kernels, the ray count
                        summed)
  parallel/distributed.py  torch.distributed process groups: initialize,
                        the global mesh, host_local_slice, gather_image
  tools/distributed_smoke.py  one process of the two-process sharded
                        smoke (render and training step over a group)
  cli.py                headless HUD CLI (--backend sharded|parity,
                        --batch, --resume, --save-state)
  serve.py              live progressive viewer (python -m
                        toypathtracer_torch.serve)
  checkpoint.py         frame state, scene and train state (.npz, the JAX
                        package's layouts)
  profiling.py          the HUD and its 10-frame FrameTimer, CUDA-event
                        timing
  native.py             ctypes binding of native/tptnative.cpp (sRGB,
                        TGA payload, metrics, blend; built with g++)
  io.py                 sRGB + TGA/PNG output
"""

from .checkpoint import (load_frame_state, load_scene, load_train_state,
                         save_frame_state, save_scene, save_train_state)
from .config import FLAG_ANIMATE, FLAG_PROGRESSIVE, RenderConfig
from .render.parity import render_frame_parity, render_frame_parity_pp
from .scaled import (ScaledScene, make_scaled_scene, refresh_chunk_aabb,
                     scaled_scene_from_arrays)
from .scene import Scene, make_scene

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Scene",
    "make_scene",
    "ScaledScene",
    "make_scaled_scene",
    "refresh_chunk_aabb",
    "scaled_scene_from_arrays",
    "FLAG_ANIMATE",
    "FLAG_PROGRESSIVE",
    "render_frame_parity",
    "render_frame_parity_pp",
    "save_frame_state",
    "load_frame_state",
    "save_scene",
    "load_scene",
    "save_train_state",
    "load_train_state",
]
