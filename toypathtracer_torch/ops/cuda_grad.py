"""The gradient and lockstep kernels' wrappers (counterpart of
toypathtracer_tpu/ops/pallas_grad.py).

`render_tile_grad` launches the hand-written CUDA gradient kernel of
csrc/grad.cu (the port of pallas_grad.py::_grad_kernel) and
`render_tile_lockstep` its primal-only twin (::_lockstep_fwd_kernel) on
CUDA tensors; on CPU tensors they run the plain versions
(render/wavefront.render_tile_grad_plain and render_tile_plain).  There is
no fallback: on a CUDA tensor a failed build or launch raises.
`launches["grad"]` and `launches["lockstep"]` count wrapper launches (one
gradient launch is the kernel and the small kernel that sums its
per-block partials).

`render_frame_diff` / `render_tile_diff` are the differentiable renders of
the training step: a torch.autograd.Function on the packed scene table
whose forward is the render kernel (or the lockstep kernel) and whose
backward is the gradient kernel; pack_scene's own autograd carries the
table's cotangent back to the Scene fields.

In this port the three kernels run one per-pixel function (csrc/trace.cuh
render_pixel), so the lockstep primal is bit-equal to the render kernel's
image and `lockstep_primal` changes which kernel runs, not the value.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import RenderConfig, resolve_device
from ..render.wavefront import (check_hard_gradients, render_tile_grad_plain,
                                render_tile_plain)
from ..scene import Scene
from . import _build
from .cuda_render import (check_device, checked_tab, cuda_call,
                          kernel_inputs, launch_forward, pack_scene,
                          render_params, render_tile)

# The gradient kernel keeps a (14, N) cotangent table per thread
# (csrc/grad.cu kGradMaxSpheres).
MAX_SPHERES = 64

PARAM_FIELDS = ("center", "radius", "albedo", "emissive", "roughness", "ri")

launches = {"grad": 0, "lockstep": 0}


def _launch_grad(scene, tab, cfg, frame, g_img, x0, y0, height, width):
    lib = _build.load_library()
    mat, lights, cam = kernel_inputs(scene, cfg)
    dev = scene.device
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    params = render_params(scene, cfg, frame, x0, y0, height, width)
    blocks = lib.tpt_grad_blocks(ctypes.byref(params))
    partial = torch.empty((blocks, 14, scene.n_spheres), dtype=torch.float32,
                          device=dev)
    d_tab = torch.empty((14, scene.n_spheres), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.tpt_grad_launch(
            tab.data_ptr(), mat.data_ptr(), lights.data_ptr(), cam.data_ptr(),
            ctypes.byref(params), g_img.data_ptr(), out.data_ptr(),
            rays.data_ptr(), partial.data_ptr(), d_tab.data_ptr(), stream)
    cuda_call(lib, "grad", code)
    launches["grad"] += 1
    return out, rays, d_tab


def render_tile_lockstep(scene: Scene, cfg: RenderConfig, frame: int,
                         x0: int, y0: int, height: int, width: int, tab=None):
    """The gradient kernel's primal alone (K4) for the (height, width)
    sub-image at global pixel (x0, y0): the lockstep kernel on a card, the
    plain version on the CPU.  Returns ((height, width, 3) float32, 0-d
    int64 ray count of the sub-image's pixels)."""
    tab = checked_tab(scene, x0, y0, height, width, tab)
    if scene.device.type == "cuda":
        out = launch_forward("lockstep", scene, tab, cfg, frame, x0, y0,
                             height, width)
        launches["lockstep"] += 1
        return out
    if scene.device.type == "cpu":
        return render_tile_plain(scene, cfg, frame, x0, y0, height, width,
                                 tab=tab)
    raise ValueError(f"no renderer for device {scene.device}")


def render_tile_grad(scene: Scene, cfg: RenderConfig, frame: int, g_img,
                     x0: int, y0: int, height: int, width: int, tab=None):
    """Value and packed-scene cotangent of the (height, width) sub-image at
    global pixel (x0, y0) for the pixel cotangent g_img ((height, width, 3)):
    the gradient kernel (K3) on a card, autograd through the plain version
    on the CPU.  `tab` is the packed table (default pack_scene(scene)).

    Returns ((height, width, 3) float32 image, 0-d int64 ray count,
    d_packed (14, N) float32)."""
    check_hard_gradients(cfg)
    if scene.n_spheres > MAX_SPHERES:
        raise ValueError(f"the gradient kernel takes at most {MAX_SPHERES} "
                         f"spheres, got {scene.n_spheres}")
    tab = checked_tab(scene, x0, y0, height, width, tab)
    if tuple(g_img.shape) != (height, width, 3):
        raise ValueError(f"pixel cotangent must be ({height}, {width}, 3), "
                         f"got {tuple(g_img.shape)}")
    check_device(scene, g_img)
    g_img = g_img.detach().to(torch.float32).contiguous()
    if scene.device.type == "cuda":
        return _launch_grad(scene, tab, cfg, frame, g_img, x0, y0, height,
                            width)
    if scene.device.type == "cpu":
        return render_tile_grad_plain(scene, cfg, frame, g_img, x0, y0,
                                      height, width, tab=tab)
    raise ValueError(f"no renderer for device {scene.device}")


def scene_cotangent_from_packed(scene: Scene, d_packed) -> Scene:
    """Pull a packed-table cotangent back through pack_scene to the Scene
    fields (radius^2, 1/radius with radius <= 0 -> 0, and radius all reach
    `radius`).  Returns a Scene whose fields are the gradients."""
    leaves = {f: getattr(scene, f).detach().requires_grad_(True)
              for f in PARAM_FIELDS}
    with torch.enable_grad():
        tab = pack_scene(scene.replace(**leaves))
        grads = torch.autograd.grad(tab, list(leaves.values()), d_packed)
    return scene.replace(**dict(zip(PARAM_FIELDS, grads)))


class _PackedRender(torch.autograd.Function):
    """image = render(tab): forward the render kernel (or the lockstep
    kernel), backward the gradient kernel."""

    @staticmethod
    def forward(ctx, tab, scene, cfg, frame, tile, lockstep):
        render = render_tile_lockstep if lockstep else render_tile
        img, rays = render(scene, cfg, frame, *tile, tab=tab)
        ctx.save_for_backward(tab)
        ctx.args = (scene, cfg, frame, tile)
        ctx.mark_non_differentiable(rays)
        return img, rays

    @staticmethod
    def backward(ctx, g_img, _g_rays):
        tab, = ctx.saved_tensors
        scene, cfg, frame, (x0, y0, height, width) = ctx.args
        _, _, d_tab = render_tile_grad(scene, cfg, frame, g_img, x0, y0,
                                       height, width, tab=tab)
        return d_tab, None, None, None, None, None


def render_tile_diff(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                     y0: int, height: int, width: int,
                     lockstep_primal: bool = False):
    """Differentiable (height, width) sub-image at global pixel (x0, y0) on
    the scene's device (pallas_grad.render_tile_pallas_diff): forward the
    render kernel (the lockstep kernel with lockstep_primal), backward the
    gradient kernel; the plain versions on the CPU.  The band unit a
    multi-device step differentiates.  Returns ((height, width, 3) float32,
    0-d int64 ray count)."""
    check_hard_gradients(cfg)
    tab = pack_scene(scene)
    return _PackedRender.apply(tab, scene, cfg, frame,
                               (x0, y0, height, width), lockstep_primal)


def render_frame_diff(scene: Scene, cfg: RenderConfig, frame: int,
                      lockstep_primal: bool = False, device="cuda"):
    """Differentiable full frame on `device` (default: the card; "cpu"
    runs the plain versions), the counterpart of
    pallas_grad.render_frame_pallas_diff.  Gradients reach the fields of
    `scene` through the move to the device.  Returns ((H, W, 3) float32,
    0-d int64 ray count)."""
    scene = scene.to(resolve_device(device))
    return render_tile_diff(scene, cfg, frame, 0, 0, cfg.height, cfg.width,
                            lockstep_primal)
