"""Whole-frame plain PyTorch renderer (counterpart of toypathtracer_tpu/
render/wavefront.py).

`render_tile_plain` is the plain version of the CUDA render kernel and of
the lockstep kernel: the same inputs (packed scene table, material types,
emissive ids, the 22-float camera), the same per-pixel function,
vectorised over pixels in eager torch.  `render_tile_grad_plain` runs
autograd through it: the plain version of the gradient kernel, the hard
selects' or (soft_silhouette_eps > 0) the soft-silhouette estimator's.
`render_tile_stats_plain` is the plain version of the stats render
kernel, with its occupancy counters.  The
ops/ wrappers take them for CPU tensors, and chip_smoke.py holds the
kernels against them on the card.  Nothing on the main path calls them
when a card is present.

Image layout: (H, W, 3) float32 with row 0 at the bottom (v ~ 0), the
reference backbuffer layout (Test.cpp:278-297).
"""

from __future__ import annotations

import torch

from ..camera import make_camera
from ..config import RenderConfig
from ..ops import tracecore as tc
from ..ops.cuda_render import (StatsCounters, pack_scene, padded_grid,
                               warp_grid)
from ..scene import Scene


def camera_scalars(scene: Scene, cfg: RenderConfig) -> dict:
    """The camera dict with plain Python floats (exact float32 values)."""
    cam = make_camera(scene.camera, cfg.width / cfg.height)
    return {k: (float(v) if k == "lens_radius" else tuple(map(float, v)))
            for k, v in cam.items()}


def differentiated(tab) -> bool:
    """Whether autograd will differentiate a render from `tab` (grad
    enabled and the table requiring it)."""
    return torch.is_grad_enabled() and tab.requires_grad


def gradient_soft_eps(cfg: RenderConfig, tab) -> float:
    """The soft-silhouette estimator's eps for a render from `tab`: the
    config's where autograd will differentiate the render, else 0.  The
    estimator changes the gradient and not the image, so a render that is
    not differentiated skips it."""
    return cfg.soft_silhouette_eps if differentiated(tab) else 0.0


def render_tile_plain(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                      y0: int, height: int, width: int, tab=None):
    """Render the (height, width) sub-image whose lower-left pixel is the
    global pixel (x0, y0), on the scene's device, from `tab` (default
    pack_scene(scene)).  Autograd runs through it when `tab` or the scene
    requires grad: the lockstep form, with the soft-silhouette estimator's
    terms where cfg.soft_silhouette_eps > 0, or with cfg.diff_wavefront
    the wavefront (tracecore.render_pixels_diff), whose image is the same
    bit for bit.  Returns ((height, width, 3) float32, int64 ray count as a
    0-d tensor)."""
    if tab is None:
        tab = pack_scene(scene)
    col, work = render_pixel_grid(scene, cfg, frame, height, width, tab,
                                  x0, y0,
                                  soft_eps=gradient_soft_eps(cfg, tab),
                                  diff=differentiated(tab))
    img = torch.stack(col, dim=-1).reshape(height, width, 3)
    return img, work.traced.sum() + work.shadow.sum()


def render_pixel_grid(scene: Scene, cfg: RenderConfig, frame: int,
                      height: int, width: int, tab, x0: int = 0, y0: int = 0,
                      stats: bool = False, soft_eps: float = 0.0,
                      diff: bool = False):
    """tracecore.render_pixels over the (height, width) pixels whose
    lower-left is the global pixel (x0, y0), row-major, from the packed
    table `tab`; diff=True: the differentiable render's dispatch,
    tracecore.render_pixels_diff."""
    dev = scene.device
    yy, xx = torch.meshgrid(
        torch.arange(y0, y0 + height, device=dev, dtype=torch.int64),
        torch.arange(x0, x0 + width, device=dev, dtype=torch.int64),
        indexing="ij")
    mat = torch.tensor(scene.mat_type, dtype=torch.int64, device=dev)
    args = (tab, mat, scene.emissive_ids, cfg, camera_scalars(scene, cfg),
            xx.reshape(-1), yy.reshape(-1), frame)
    if diff and not stats:
        return tc.render_pixels_diff(*args, soft_eps=soft_eps)
    return tc.render_pixels(*args, stats=stats, soft_eps=soft_eps)


def render_frame_plain(scene: Scene, cfg: RenderConfig, frame: int):
    """Render one full frame on the scene's device.  `frame` seeds the
    per-pixel RNG (ComputeShader.hlsl:380).  Returns ((H, W, 3) float32,
    0-d int64 ray count)."""
    return render_tile_plain(scene, cfg, frame, 0, 0, cfg.height, cfg.width)


def render_tile_grad_plain(scene: Scene, cfg: RenderConfig, frame: int,
                           g_img, x0: int, y0: int, height: int, width: int,
                           tab=None):
    """Value and packed-scene cotangent of a sub-image for the pixel
    cotangent g_img ((height, width, 3)): autograd through
    render_tile_plain, the gradient kernel's plain version, and with
    cfg.diff_wavefront the plain version of the differentiable wavefront's
    kernel pair (the wavefront, each iteration rematerialized).  The
    lockstep graph holds every bounce's (pixels, spheres) intermediates,
    so it takes a band of a large frame, not the frame.  Returns (image,
    0-d int64 ray count, d_packed (SCENE_ROWS, N) float32).  With
    cfg.soft_silhouette_eps > 0 it is the soft-silhouette estimator's
    cotangent."""
    if tab is None:
        tab = pack_scene(scene)
    tab = tab.detach().requires_grad_(True)
    with torch.enable_grad():
        img, rays = render_tile_plain(scene, cfg, frame, x0, y0, height,
                                      width, tab=tab)
        d_tab, = torch.autograd.grad(img, tab, g_img.to(img))
    return img.detach(), rays, d_tab


def warp_counters(depths, height: int, width: int):
    """The stats render kernel's per-warp counters from each pixel's
    per-sample bounces `depths` (grid_h, grid_w, spp) over its launch grid
    of 16x8-pixel blocks, four 16x2-pixel warps each: per warp, the sum
    over samples of its deepest lane (`iters`) and its lanes' bounces
    summed (`work`), over the pixels of the (height, width) image (the
    others count 0).  Returns int32 (iters, work), each warp_grid-shaped."""
    grid_h, grid_w, spp = depths.shape
    wr, wc = warp_grid(grid_h, grid_w)
    d = torch.zeros((2 * wr, 16 * wc, spp), dtype=torch.int64,
                    device=depths.device)
    d[:height, :width] = depths[:height, :width]
    d = d.reshape(wr, 2, wc, 16, spp)
    return (d.amax(dim=(1, 3)).sum(dim=-1).to(torch.int32),
            d.sum(dim=(1, 3, 4)).to(torch.int32))


def render_tile_stats_plain(scene: Scene, cfg: RenderConfig, frame: int,
                            tab=None):
    """The plain version of the stats render kernel: every pixel of the
    frame padded to whole TPU tiles rendered with its trip counts
    (tracecore.render_pixels(stats=True)), the image cropped and the rays
    counted over the image's pixels.  Returns ((H, W, 3) float32, 0-d
    int64 rays, ops/cuda_render.StatsCounters)."""
    grid_h, grid_w = padded_grid(cfg)
    col, work, trips = render_pixel_grid(
        scene, cfg, frame, grid_h, grid_w,
        pack_scene(scene) if tab is None else tab, stats=True)
    H, W = cfg.height, cfg.width
    img = torch.stack(col, dim=-1).reshape(grid_h, grid_w, 3)[:H, :W]
    rays = (work.traced + work.shadow).reshape(grid_h, grid_w)[:H, :W].sum()

    def plane(x):
        return x.reshape(grid_h, grid_w).to(torch.int32)
    return img, rays, StatsCounters(
        plane(trips.bounces), plane(trips.cutoffs), plane(trips.last_cutoff),
        *warp_counters(trips.depths.reshape(grid_h, grid_w, -1), H, W))
