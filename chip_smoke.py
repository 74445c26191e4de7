"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and hold its
kernel against the plain PyTorch version.

    python3 chip_smoke.py

Phases (one JSON line each on stdout; any failure raises and exits
non-zero):
  1. device: the card, torch/CUDA versions, the nvcc build of csrc/.
  2. kernel vs plain at 320x176, spp 2, depth 6, frames 0-3: the big
     scene, the big scene without light sampling, the small scene.
  3. the main path: RenderSession(device="cuda") at 1280x720, spp 4,
     depth 10, 46 spheres, 16 progressive frames plus one animated frame;
     frame 0's rays against the plain version and the TPU's frame-0 count,
     the 16-frame image against 16 plain frames (8x8 block gates), and one
     kernel launch per frame.
  4. timing with CUDA events: 64 steady frames after 4 warm-up frames.
  5. the `kernels` line.
Then the card's name and power limit as nvidia-smi reports them, and the
`ok` line last.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def block_gates(a, b):
    """Mean and max |diff| of 8x8 block means of sqrt-tonemapped images
    (the progressive gate of tools/tpu_parity.py, at 8x8 blocks)."""
    h, w = a.shape[0] // 8 * 8, a.shape[1] // 8 * 8

    def blocks(x):
        t = torch.sqrt(torch.clamp_min(x[:h, :w].double(), 0.0))
        return t.reshape(h // 8, 8, w // 8, 8, 3).mean(dim=(1, 3))
    d = (blocks(a) - blocks(b)).abs()
    return float(d.mean()), float(d.max())


def compare(img_k, rays_k, img_p, rays_p):
    d = (img_k - img_p).abs()
    rk, rp = int(rays_k), int(rays_p)
    return {"rays_kernel": rk, "rays_plain": rp,
            "rays_rel_diff": abs(rk - rp) / max(rp, 1),
            "mean_abs_diff": float(d.mean()), "max_abs_diff": float(d.max()),
            "frac_within_1e-4": float((d.amax(dim=-1) <= 1e-4)
                                      .double().mean()),
            "finite": bool(torch.isfinite(img_k).all())}


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    from toypathtracer_torch import (FLAG_ANIMATE, FLAG_PROGRESSIVE,
                                     RenderConfig, make_scene)
    from toypathtracer_torch.ops import _build, cuda_render
    from toypathtracer_torch.ops import tracecore as tc
    from toypathtracer_torch.profiling import time_device_call
    from toypathtracer_torch.render import frame as frame_mod
    from toypathtracer_torch.render.wavefront import (camera_scalars,
                                                      render_frame_plain)

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    _build.load_library()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": build_s, "library": str(lib_path.name)})

    # ---- 2. kernel vs plain, small size ---------------------------------
    small_cfg = RenderConfig(width=320, height=176, samples_per_pixel=2,
                             max_depth=6)
    cases = [("big", make_scene(big=True), small_cfg),
             ("big_no_nee", make_scene(big=True),
              small_cfg.replace(do_light_sampling=False)),
             ("small", make_scene(big=False), small_cfg)]
    for name, scene, cfg in cases:
        scene = scene.to(dev)
        for frame in range(4):
            img_k, rays_k = cuda_render.render_tile(
                scene, cfg, frame, 0, 0, cfg.height, cfg.width)
            img_p, rays_p = render_frame_plain(scene, cfg, frame)
            torch.cuda.synchronize()
            r = compare(img_k, rays_k, img_p, rays_p)
            emit({"phase": "kernel_vs_plain", "case": name, "frame": frame,
                  **r})
            check(r["finite"] and tuple(img_k.shape) == (176, 320, 3),
                  f"{name} frame {frame}: shape/finite")
            check(r["rays_rel_diff"] <= 5e-4, f"{name} frame {frame}: rays")
            check(r["mean_abs_diff"] <= 1e-3, f"{name} frame {frame}: mean")

    # ---- 3. the main path at full size ----------------------------------
    cfg = RenderConfig(width=1280, height=720, samples_per_pixel=4,
                       max_depth=10)
    scene = make_scene(big=True)
    n_frames = 16
    sess = frame_mod.RenderSession(scene, cfg, flags=FLAG_PROGRESSIVE,
                                   device="cuda")
    cuda_render.launches["render"] = 0
    rays = []
    img0 = None
    for f in range(n_frames):
        img, r = sess.step(time=0.0)
        if f == 0:
            img0 = img.clone()
        rays.append(r)
    accum = sess.state.accum.clone()
    sess.set_flags(FLAG_PROGRESSIVE | FLAG_ANIMATE)
    img_anim, rays_anim = sess.step(time=1.0)
    img_anim = img_anim.clone()
    torch.cuda.synchronize()
    main_launches = cuda_render.launches["render"]
    rays = [int(r) for r in rays]

    # the same frames through the plain version on the card
    scene_d = scene.to(dev)
    st = frame_mod.init_frame_state(cfg, dev)
    plain_rays = []
    plain0 = None
    for f in range(n_frames):
        st, img_p, r = frame_mod.progressive_step(
            st, scene_d, 0.0, cfg, FLAG_PROGRESSIVE,
            render_fn=render_frame_plain)
        if f == 0:
            plain0 = img_p.clone()
        plain_rays.append(int(r))
    anim_p, rays_anim_p = render_frame_plain(scene_d.animate(1.0), cfg, 0)

    tpu_rays_f0 = 16772198  # docs/measured/tpu_parity.json:49
    f0 = compare(img0, rays[0], plain0, plain_rays[0])
    bm, bx = block_gates(accum, st.accum)
    anim = compare(img_anim, rays_anim, anim_p, rays_anim_p)
    main = {"phase": "main_path", "frames": n_frames + 1,
            "launches": main_launches, "frame0": f0,
            "frame0_rays_rel_vs_tpu": abs(rays[0] - tpu_rays_f0) / tpu_rays_f0,
            "rays_per_frame": rays,
            "rays_16f_rel_diff": abs(sum(rays) - sum(plain_rays))
            / sum(plain_rays),
            "block_mean_abs": bm, "block_max_abs": bx,
            "accum_finite": bool(torch.isfinite(accum).all()),
            "animated": anim}
    emit(main)
    check(main_launches == n_frames + 1,
          f"{main_launches} launches for {n_frames + 1} frames")
    check(tuple(accum.shape) == (720, 1280, 3) and main["accum_finite"],
          "accumulated image shape/finite")
    check(f0["rays_rel_diff"] <= 5e-4, "frame 0 rays vs plain")
    check(main["frame0_rays_rel_vs_tpu"] <= 5e-4, "frame 0 rays vs TPU")
    check(bm <= 0.02 and bx <= 0.2, "16-frame block gates")
    check(anim["finite"] and anim["rays_rel_diff"] <= 5e-4, "animated frame")

    # ---- 4. timing ------------------------------------------------------
    sess = frame_mod.RenderSession(scene, cfg, flags=FLAG_PROGRESSIVE,
                                   device="cuda")
    for f in range(4):
        sess.step(time=0.0)
    torch.cuda.synchronize()
    n_timed = 64
    timed_rays = []
    step_s, _ = time_device_call(
        lambda: timed_rays.append(sess.step(time=0.0)[1]), repeats=n_timed)
    step_ms = step_s * 1e3
    rays_per_frame = frame_mod.sum_rays(torch.stack(timed_rays)) / n_timed

    # the kernel alone (wrapper call) and the plain version, same inputs
    kernel_s, _ = time_device_call(cuda_render.render_tile, scene_d, cfg, 0,
                                   0, 0, cfg.height, cfg.width, repeats=16)
    plain_s, _ = time_device_call(render_frame_plain, scene_d, cfg, 0)
    kernel_ms, plain_ms = kernel_s * 1e3, plain_s * 1e3

    # Bound: the FP32 arithmetic the kernel does on frame 0's data, counted
    # from csrc/trace.cuh with the plain version's work counters: 19
    # operations per sphere root test (3 sub, 5 for nb, 6 for c, 2 for the
    # discriminant, sqrt, 2 roots) -- every sphere for each camera/bounce
    # ray, the light's own sphere for each shadow ray -- and 20 per sphere
    # of each shadow ray's occlusion loop, which stops at the first
    # occluder.  Shading, compares and selects are not counted, and sqrt
    # counts as one operation, so the bound is low.  67 TFLOP/s: H100 SXM
    # FP32 peak at 700 W.
    tab = cuda_render.pack_scene(scene_d)
    mat = torch.tensor(scene.mat_type, dtype=torch.int64, device=dev)
    yy, xx = torch.meshgrid(torch.arange(cfg.height, device=dev),
                            torch.arange(cfg.width, device=dev),
                            indexing="ij")
    _, work = tc.render_pixels(
        tab, mat, scene.emissive_ids, cfg, camera_scalars(scene, cfg),
        xx.reshape(-1), yy.reshape(-1), 0)
    traced, shadow, occ_tests = (int(w.sum()) for w in work)
    ops = (19 * scene.n_spheres * traced + 19 * shadow + 20 * occ_tests)
    ops_ms = ops / 67e12 * 1e3
    # bytes: the packed scene, material ids, lights and camera read once,
    # the image written once, the ray counter; 3.35 TB/s HBM3
    n_bytes = (4 * (14 * scene.n_spheres + scene.n_spheres
                    + len(scene.emissive_ids) + 22)
               + 4 * 3 * cfg.width * cfg.height + 8)
    bytes_ms = n_bytes / 3.35e12 * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    emit({"phase": "timing", "nvidia_smi": smi,
          "step_ms_per_frame": step_ms, "kernel_ms": kernel_ms,
          "mray_s": rays_per_frame / (step_ms * 1e-3) * 1e-6,
          "rays_per_frame": rays_per_frame, "plain_ms": plain_ms,
          "frame0_traced_rays": traced, "frame0_shadow_rays": shadow,
          "frame0_occlusion_sphere_tests": occ_tests,
          "bound_fp32_ops": ops, "bound_ops_ms": ops_ms,
          "bound_bytes": n_bytes, "bound_bytes_ms": bytes_ms,
          "bound_ms": bound_ms,
          "bound_peak": "67 TFLOP/s FP32 (H100 SXM, 700 W)",
          "library_call": None})

    emit({"kernels": [{
        "name": "render", "route": "cuda",
        "source": "toypathtracer_torch/csrc/render.cu",
        "replaces": "toypathtracer_tpu/ops/pallas_render.py:152",
        "launches": main_launches,
        "max_abs_err": f0["max_abs_diff"],
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "vs_plain": {"tolerance": "rays rel <= 5e-4, mean |diff| <= 1e-3, "
                                  "8x8 block mean <= 0.02, max <= 0.2",
                     "rays_rel_diff": f0["rays_rel_diff"],
                     "mean_abs_diff": f0["mean_abs_diff"],
                     "frac_within_1e-4": f0["frac_within_1e-4"],
                     "block_mean_abs": bm, "block_max_abs": bx}}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
