"""The render kernel's wrapper (counterpart of toypathtracer_tpu/ops/
pallas_render.py).

`render_tile` and `render_frame` launch the hand-written CUDA kernel of
csrc/render.cu (the port of pallas_render.py::_render_kernel) on CUDA
tensors and run the plain PyTorch version (render/wavefront.py) on CPU
tensors.  There is no fallback: on a CUDA tensor a failed build or launch
raises.  `launches["render"]` counts kernel launches, so a run can show
that its frames went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..camera import camera_to_array, make_camera
from ..config import RenderConfig, resolve_device
from ..scene import Scene
from . import _build

# Largest scene the kernel stages in shared memory (csrc/trace.cuh).
MAX_SPHERES = 512
MAX_LIGHTS = 16

launches = {"render": 0}


def pack_scene(scene: Scene) -> torch.Tensor:
    """Scene -> (SCENE_ROWS, N) float32 table on the scene's device: center
    xyz, radius^2, 1/radius, radius, albedo rgb, emission rgb, roughness,
    ri (pallas_render.py:53-80).  A radius <= 0 (a padded sphere) gets
    1/radius = 0 instead of inf, so normals stay finite."""
    r = scene.radius
    inv_radius = torch.where(r > 0, 1.0 / torch.clamp_min(r, 1e-8), 0.0)
    c, a, e = scene.center, scene.albedo, scene.emissive
    return torch.stack([
        c[:, 0], c[:, 1], c[:, 2], r * r, inv_radius, r,
        a[:, 0], a[:, 1], a[:, 2], e[:, 0], e[:, 1], e[:, 2],
        scene.roughness, scene.ri,
    ]).to(torch.float32).contiguous()


def render_params(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                  y0: int, height: int, width: int) -> _build.RenderParams:
    """The kernel's scalar arguments (tpt::RenderParams)."""
    f32 = np.float32
    return _build.RenderParams(
        x0=x0, y0=y0, height=height, width=width,
        frame=int(frame) & 0xFFFFFFFF,
        spp=cfg.samples_per_pixel, max_depth=cfg.max_depth,
        light_sampling=int(cfg.do_light_sampling),
        mitsuba=int(cfg.do_mitsuba_compare),
        n_spheres=scene.n_spheres, n_lights=len(scene.emissive_ids),
        inv_w=f32(cfg.inv_width), inv_h=f32(cfg.inv_height),
        inv_spp=f32(1.0 / cfg.samples_per_pixel),
        t_min=f32(cfg.min_t), t_max=f32(cfg.max_t))


def _check_scene(scene: Scene):
    n = scene.n_spheres
    if not 1 <= n <= MAX_SPHERES:
        raise ValueError(f"the render kernel takes 1..{MAX_SPHERES} spheres, "
                         f"got {n}")
    if len(scene.emissive_ids) > MAX_LIGHTS:
        raise ValueError(f"the render kernel takes at most {MAX_LIGHTS} "
                         f"emissive spheres, got {len(scene.emissive_ids)}")
    if any(m not in (0, 1, 2) for m in scene.mat_type):
        raise ValueError(f"material types must be 0, 1 or 2: "
                         f"{scene.mat_type}")
    if any(not 0 <= e < n for e in scene.emissive_ids):
        raise ValueError(f"emissive ids out of range: {scene.emissive_ids}")
    for name in ("center", "radius", "albedo", "emissive", "roughness", "ri"):
        t = getattr(scene, name)
        if t.dtype != torch.float32 or t.shape[0] != n:
            raise ValueError(f"scene.{name} must be float32 with {n} rows, "
                             f"got {t.dtype} {tuple(t.shape)}")


def check_device(scene: Scene, *tensors):
    """Every scene field and every given tensor on the scene's device."""
    dev = scene.device
    for name in ("center", "radius", "albedo", "emissive", "roughness", "ri"):
        if getattr(scene, name).device != dev:
            raise ValueError(f"scene.{name} is on "
                             f"{getattr(scene, name).device}, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"a tensor is on {t.device}, not {dev}")


def kernel_inputs(scene: Scene, cfg: RenderConfig):
    """The kernels' static inputs on the scene's device: int32 material
    types, emissive ids and the 22-float camera.  Host data goes up through
    pinned buffers without blocking, so frames queue back to back instead
    of draining the stream at every call."""
    mat = np.array(scene.mat_type, np.int32)
    mat = torch.from_numpy(mat).pin_memory().to(scene.device,
                                                 non_blocking=True)
    return (mat, *kernel_camera(scene, cfg))


def kernel_camera(scene, cfg: RenderConfig):
    """The int32 emissive ids and the 22-float camera on the scene's
    device (a Scene or a ScaledScene), uploaded as kernel_inputs does."""
    dev = scene.device
    ids = np.array(scene.emissive_ids or (0,), np.int32)
    ids = torch.from_numpy(ids).pin_memory().to(dev, non_blocking=True)
    cam = torch.from_numpy(camera_to_array(
        make_camera(scene.camera, cfg.width / cfg.height)))
    cam = cam.pin_memory().to(dev, non_blocking=True)
    return ids, cam


def checked_tab(scene: Scene, x0: int, y0: int, height: int, width: int,
                tab=None) -> torch.Tensor:
    """Validate a kernel call on the (height, width) sub-image at (x0, y0)
    and return the packed table it reads (default pack_scene(scene)):
    (SCENE_ROWS, N) float32, contiguous, detached, on the scene's
    device."""
    _check_scene(scene)
    if not (height >= 1 and width >= 1 and x0 >= 0 and y0 >= 0):
        raise ValueError(f"bad sub-image {height}x{width} at ({x0}, {y0})")
    if tab is None:
        tab = pack_scene(scene)
    if tab.shape != (14, scene.n_spheres) or tab.dtype != torch.float32:
        raise ValueError(f"packed table must be float32 (14, "
                         f"{scene.n_spheres}), got {tab.dtype} "
                         f"{tuple(tab.shape)}")
    check_device(scene, tab)
    return tab.detach().contiguous()


def cuda_call(lib, name: str, code: int):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({lib.tpt_error_string(code).decode()})")


def launch_forward(kernel: str, scene: Scene, tab: torch.Tensor,
                   cfg: RenderConfig, frame: int, x0: int, y0: int,
                   height: int, width: int):
    """Launch the forward kernel tpt_<kernel>_launch ("render" or
    "lockstep") on the current stream; returns ((height, width, 3)
    float32 image, 0-d int64 ray count)."""
    lib = _build.load_library()
    mat, lights, cam = kernel_inputs(scene, cfg)
    dev = scene.device
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    params = render_params(scene, cfg, frame, x0, y0, height, width)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, f"tpt_{kernel}_launch")(
            tab.data_ptr(), mat.data_ptr(), lights.data_ptr(), cam.data_ptr(),
            ctypes.byref(params), out.data_ptr(), rays.data_ptr(), stream)
    cuda_call(lib, kernel, code)
    return out, rays


def render_tile(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                y0: int, height: int, width: int, tab=None):
    """Render the (height, width) sub-image whose lower-left pixel is the
    global pixel (x0, y0), on the scene's device: the CUDA kernel for a
    scene on a card, the plain PyTorch version for a scene on the CPU.
    `tab` is the packed table to render (default pack_scene(scene)); the
    kernel does not differentiate it (ops/cuda_grad does).

    Returns ((height, width, 3) float32 image, 0-d int64 ray count: every
    camera, bounce and shadow ray of the sub-image's pixels)."""
    tab = checked_tab(scene, x0, y0, height, width, tab)
    if scene.device.type == "cuda":
        out = launch_forward("render", scene, tab, cfg, frame, x0, y0, height,
                             width)
        launches["render"] += 1
        return out
    if scene.device.type == "cpu":
        from ..render.wavefront import render_tile_plain
        return render_tile_plain(scene, cfg, frame, x0, y0, height, width,
                                 tab=tab)
    raise ValueError(f"no renderer for device {scene.device}")


def render_frame(scene: Scene, cfg: RenderConfig, frame: int,
                 device="cuda"):
    """Render one full frame on `device` (default: the card; "cpu" runs
    the plain PyTorch version).  Raises RuntimeError for "cuda" without a
    card.  Returns ((H, W, 3) float32, 0-d int64 ray count)."""
    scene = scene.to(resolve_device(device))
    return render_tile(scene, cfg, frame, 0, 0, cfg.height, cfg.width)
