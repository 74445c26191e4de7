"""Inverse rendering: recover scene parameters from images (counterpart of
toypathtracer_tpu/inverse.py).

Adam on a pixel loss against a target render optimises the trainable
Scene fields.  The loss's render is ops/cuda_grad.render_frame_diff: on a
card the render kernel (or with lockstep_primal the lockstep kernel)
forward and the gradient kernel backward, on the CPU the plain versions,
chosen by the device the renderer works on.  Discontinuous events
(nearest-hit argmin, shadow visibility, the dielectric branch) pass the
straight-through gradient of the taken branch, as in the JAX package,
unless cfg.soft_silhouette_eps > 0: then the soft-silhouette estimator's
sigmoid terms carry the silhouette and shadow-boundary gradients that
geometry recovery (centers, radii, animation time) needs.  The JAX
package's recipe for geometry (toypathtracer_tpu/inverse.py): a small eps
such as 0.05 with image_l2_tonemapped.

With a `mesh` (parallel/mesh.RowMesh) the step is row-sharded
(make_sharded_value_and_grad): each band renders and differentiates its
rows on its device, and the band losses and scene gradients are summed,
over the process group with torch.distributed where there is one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from .config import RenderConfig, resolve_device
from .ops.cuda_grad import PARAM_FIELDS, render_frame_diff, render_tile_diff
from .parallel.mesh import (RowMesh, all_reduce_sum, check_divisible,
                            device_scope, replicate)
from .scene import Scene


def _check_fields(trainable: Sequence[str]):
    unknown = set(trainable) - set(PARAM_FIELDS)
    if unknown:
        raise ValueError(f"unknown trainable fields: {sorted(unknown)}")


def scene_grad_mask(scene: Scene, trainable: Sequence[str]) -> Scene:
    """A Scene-shaped set of 0/1 float tensors selecting trainable
    fields."""
    _check_fields(trainable)
    return scene.replace(**{
        f: torch.full_like(getattr(scene, f), 1.0 if f in trainable else 0.0)
        for f in PARAM_FIELDS})


def image_l2(img, target):
    """Mean squared pixel error (the inverse-rendering objective)."""
    d = img - target
    return torch.mean(d * d)


def image_l2_tonemapped(img, target):
    """L2 on Reinhard-compressed radiance, x/(1+|x|): bounds every
    pixel's error at 1, so the ~25x-brighter emissive pixels do not
    dominate the objective."""
    a = img / (1.0 + torch.abs(img))
    b = target / (1.0 + torch.abs(target))
    d = a - b
    return torch.mean(d * d)


def render_loss(scene: Scene, target, cfg: RenderConfig, frame: int,
                loss_fn=image_l2, lockstep_primal: bool = False):
    """Pixel loss of a differentiable render of `scene` on its own device
    against `target` (H, W, 3)."""
    img, _ = render_frame_diff(scene, cfg, frame, lockstep_primal,
                               device=scene.device)
    return loss_fn(img, target)


def multiview_render_loss(scene: Scene, cameras, targets, cfg: RenderConfig,
                          frame: int, loss_fn=image_l2,
                          lockstep_primal: bool = False):
    """Mean pixel loss over (camera, target) views: each view renders
    `scene.replace(camera=cam)`, one forward and one backward kernel
    launch per view, and the views' scene cotangents add up through
    autograd."""
    total = 0.0
    for cam, target in zip(cameras, targets):
        total = total + render_loss(scene.replace(camera=cam), target, cfg,
                                    frame, loss_fn, lockstep_primal)
    return total / len(cameras)


def make_sharded_value_and_grad(cfg: RenderConfig, mesh: RowMesh,
                                cameras: Optional[tuple] = None,
                                fields: Sequence[str] = PARAM_FIELDS):
    """value_and_grad of the pixel-L2 loss with the image's rows split
    into the mesh's bands (toypathtracer_tpu/inverse.py:182).  Returns
    `f(scene, target, frame) -> (loss, {field: gradient})` over `fields`,
    both on mesh.devices[0].  `target` is the whole (H, W, 3) frame, or
    (V, H, W, 3) with `cameras` (a tuple of V CameraSpec, the views
    unrolled in each band); each band reads its rows.

    Each band's loss is sum(d * d) / (H * W * 3 * V), so the band losses
    sum to the frame's mean, through ops/cuda_grad.render_tile_diff at the
    band's global y0 (the render kernel forward, the gradient kernel
    backward on a card; the plain versions on the CPU).  Each band takes
    its gradient on leaves of its own, so no band's gradient reaches
    another's sum: bands on one device share the replica's storage but
    not its autograd leaves.  Band losses and gradients are summed in
    band order on mesh.devices[0], then over the group."""
    _check_fields(fields)
    check_divisible(cfg.height, mesh.size)
    n_views = 1 if cameras is None else len(cameras)
    denom = float(cfg.height * cfg.width * 3 * n_views)
    dev0 = mesh.devices[0]

    def value_and_grad(scene: Scene, target, frame: int):
        target = torch.as_tensor(target, dtype=torch.float32)
        replicas = replicate(scene, mesh)
        loss, grads = None, None
        for dev, y0, rows in mesh.bands(cfg.height):
            with device_scope(dev):
                leaves = {f: getattr(replicas[dev], f).detach()
                          .requires_grad_(True) for f in fields}
                s = replicas[dev].replace(**leaves)
                band = target.narrow(-3, y0, rows).to(dev)
                views = ((None, band),) if cameras is None else \
                    tuple(zip(cameras, band))
                total = 0.0
                for cam, want in views:
                    view = s if cam is None else s.replace(camera=cam)
                    img, _ = render_tile_diff(view, cfg, frame, 0, y0, rows,
                                              cfg.width)
                    d = img - want
                    total = total + torch.sum(d * d)
                band_loss = total / denom
                band_grads = torch.autograd.grad(band_loss,
                                                 list(leaves.values()))
            band_loss = band_loss.detach().to(dev0)
            band_grads = [g.to(dev0) for g in band_grads]
            if loss is None:
                loss, grads = band_loss, band_grads
            else:
                loss = loss + band_loss
                grads = [a + b for a, b in zip(grads, band_grads)]
        flat = all_reduce_sum(torch.cat([loss.reshape(1)] +
                                        [g.reshape(-1) for g in grads]), mesh)
        parts = flat[1:].split([g.numel() for g in grads])
        return flat[0], {f: p.reshape(g.shape)
                         for f, p, g in zip(fields, parts, grads)}
    return value_and_grad


# optax.adam's moment decays (the JAX package keeps its defaults).
ADAM_B1 = 0.9
ADAM_B2 = 0.999


def adam_update(params: dict, grads: dict, state: dict, lr: float,
                eps: float, clip_norm: Optional[float]):
    """One step of optax.chain(optax.clip_by_global_norm(clip_norm),
    optax.adam(lr, eps=eps)) on dicts of tensors, written as optax
    writes it: the clip is g unchanged when the global norm is below
    clip_norm and (g / norm) * clip_norm otherwise, with no epsilon added
    to the norm (torch.nn.utils.clip_grad_norm_ adds 1e-6).  `state` is
    {} before the first step.  Returns (params, state); no host sync."""
    if clip_norm is not None:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        grads = {k: torch.where(norm < clip_norm, g, (g / norm) * clip_norm)
                 for k, g in grads.items()}
    count = state.get("count", 0) + 1
    b1, b2 = ADAM_B1, ADAM_B2
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
    new_params, new_state = {}, {"count": count}
    for k, g in grads.items():
        mu, nu = state.get(k, (torch.zeros_like(g), torch.zeros_like(g)))
        mu = (1.0 - b1) * g + b1 * mu
        nu = (1.0 - b2) * (g * g) + b2 * nu
        mu_hat = mu / bc1.to(g.device)
        nu_hat = nu / bc2.to(g.device)
        new_params[k] = params[k] + (-lr) * (mu_hat / (torch.sqrt(nu_hat)
                                                       + eps))
        new_state[k] = (mu, nu)
    return new_params, new_state


@dataclasses.dataclass
class InverseRenderer:
    """Adam-on-pixel-loss scene recovery (BASELINE.json config 3) on the
    card by default (render, lockstep and gradient kernels), or
    device="cpu" (their plain versions); with a `mesh`, row-sharded over
    its bands (make_sharded_value_and_grad; image_l2 only, and `device`
    is the mesh's first).  Optimises `trainable` Scene fields to match
    `target` ((H, W, 3) linear radiance, layout as render_frame; (V, H, W,
    3) with `cameras`)."""

    cfg: RenderConfig
    target: torch.Tensor
    trainable: Tuple[str, ...] = ("center", "radius", "albedo", "emissive")
    learning_rate: float = 2e-2
    mesh: Optional[RowMesh] = None
    loss_fn: Callable = image_l2
    clip_norm: Optional[float] = 1.0  # None disables gradient clipping
    # Multi-view: a tuple of CameraSpec, one per target view (the scene's
    # own camera is ignored).
    cameras: Optional[tuple] = None
    # Adam's denominator floor; a larger eps pins the noise-level
    # gradients of barely visible spheres instead of random-walking them.
    adam_eps: float = 1e-8
    # Render the loss's value with the lockstep kernel (the exact
    # function the gradient kernel differentiates) instead of the render
    # kernel.  Both give the same image in this port.
    lockstep_primal: bool = False
    device: str = "cuda"

    def __post_init__(self):
        _check_fields(self.trainable)
        self._sharded = None
        self.opt_state: dict = {}
        if self.mesh is not None:
            if self.loss_fn is not image_l2:
                raise ValueError("mesh sharding implements image_l2 only "
                                 "(the per-band partial sums assume it)")
            if self.lockstep_primal:
                raise ValueError("lockstep_primal is not implemented for "
                                 "mesh-sharded training; drop mesh or "
                                 "lockstep_primal")
            self.device = self.mesh.devices[0]
            self._sharded = make_sharded_value_and_grad(
                self.cfg, self.mesh, self.cameras, self.trainable)
        self.device = resolve_device(self.device)
        self.target = torch.as_tensor(self.target, dtype=torch.float32,
                                      device=self.device)

    def value_and_grad(self, scene: Scene, frame: int):
        """(loss, {field: gradient}) of the trainable fields at `scene`
        (on the renderer's device)."""
        if self._sharded is not None:
            return self._sharded(scene, self.target, frame)
        leaves = {f: getattr(scene, f).detach().requires_grad_(True)
                  for f in self.trainable}
        s = scene.replace(**leaves)
        if self.cameras is None:
            loss = render_loss(s, self.target, self.cfg, frame, self.loss_fn,
                               self.lockstep_primal)
        else:
            loss = multiview_render_loss(s, self.cameras, self.target,
                                         self.cfg, frame, self.loss_fn,
                                         self.lockstep_primal)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(self.trainable, grads))

    def fit(self, scene: Scene, steps: int, frame0: int = 0,
            resample: bool = True, callback: Optional[Callable] = None,
            opt_state: Optional[dict] = None):
        """Run `steps` Adam iterations from `scene`.

        resample=True: frame0 + i seeds step i's samples (unbiased
        stochastic gradients of the expected image, with a Monte-Carlo
        loss floor); resample=False: every step renders frame0, a
        deterministic objective whose loss can reach ~0 when the target
        was rendered at frame0.  `opt_state` resumes the Adam state of an
        earlier fit (self.opt_state after it, or checkpoint.
        load_train_state's); with frame0 at the steps already taken the
        fit continues as one run would.  Returns (fitted scene on the
        renderer's device, list of float losses); the Adam state is left
        in self.opt_state."""
        scene = scene.to(self.device)
        params = {f: getattr(scene, f).detach() for f in self.trainable}
        state: dict = {} if opt_state is None else {
            k: (v if k == "count" else tuple(t.to(self.device) for t in v))
            for k, v in opt_state.items()}
        losses = []
        for i in range(steps):
            frame = frame0 + i if resample else frame0
            loss, grads = self.value_and_grad(scene.replace(**params), frame)
            params, state = adam_update(params, grads, state,
                                        self.learning_rate, self.adam_eps,
                                        self.clip_norm)
            losses.append(loss)
            if callback is not None:
                callback(i, loss, scene.replace(**params))
        self.opt_state = state
        return scene.replace(**params), [float(l) for l in losses]
