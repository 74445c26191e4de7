"""Inverse rendering: recover scene parameters from images (counterpart of
toypathtracer_tpu/inverse.py, single device).

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
such as 0.05 with image_l2_tonemapped.  Not ported yet, and raising
NotImplementedError rather than ignored: row-sharded multi-device
training (`mesh`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from .config import RenderConfig, resolve_device
from .ops.cuda_grad import PARAM_FIELDS, render_frame_diff
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
    """Adam-on-pixel-loss scene recovery (BASELINE.json config 3), on one
    device: the card by default (render, lockstep and gradient kernels),
    or device="cpu" (their plain versions).  Optimises `trainable` Scene
    fields to match `target` ((H, W, 3) linear radiance, layout as
    render_frame; (V, H, W, 3) with `cameras`)."""

    cfg: RenderConfig
    target: torch.Tensor
    trainable: Tuple[str, ...] = ("center", "radius", "albedo", "emissive")
    learning_rate: float = 2e-2
    mesh: Optional[object] = None
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
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh-sharded training is not ported yet (ROADMAP queue 1 "
                "item 10); drop mesh to train on one device")
        _check_fields(self.trainable)
        self.device = resolve_device(self.device)
        self.target = torch.as_tensor(self.target, dtype=torch.float32,
                                      device=self.device)

    def value_and_grad(self, scene: Scene, frame: int):
        """(loss, {field: gradient}) of the trainable fields at `scene`
        (on the renderer's device)."""
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
            resample: bool = True, callback: Optional[Callable] = None):
        """Run `steps` Adam iterations from `scene`.

        resample=True: frame0 + i seeds step i's samples (unbiased
        stochastic gradients of the expected image, with a Monte-Carlo
        loss floor); resample=False: every step renders frame0, a
        deterministic objective whose loss can reach ~0 when the target
        was rendered at frame0.  Returns (fitted scene on the renderer's
        device, list of float losses)."""
        scene = scene.to(self.device)
        params = {f: getattr(scene, f).detach() for f in self.trainable}
        state: dict = {}
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
        return scene.replace(**params), [float(l) for l in losses]
