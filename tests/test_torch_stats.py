"""The stats render (ops/cuda_render.render_frame_stats) and the
measurement tools of the port on the CPU, where they run the kernels'
plain PyTorch versions, against the JAX package's stats render.

The TPU kernel's per-tile counters (iters: loop trips; work: live lanes
summed over trips) follow exactly from three trip counts per pixel
(ops/cuda_render.tile_counters), so the port's counters must EQUAL
render_frame_pallas_stats(interpret=True)'s, for both loops:
tests/test_pallas.py's CFG unmerged (128x16, spp 2, depth 10, tile 8x128)
and 100x20 in 16x128 tiles with 2 pixels a lane, merged (the padded
shape), frame 3.  Rays equal.  The image: at CFG within
tests/test_torch_render.py's tolerances (99.9% of pixels within 1e-4, mean
|diff| 5e-7); at 100x20, 5 of 2,000 pixels differ by up to 6.1e-3 (mean
|diff| 4.9e-6), the same against the JAX package's unmerged jnp render: the
torch-vs-XLA transcendental drift that ROADMAP.md queue 3 records, which
flips a Monte-Carlo decision on a few paths without changing any trip
count.  Gated there at 99.5% within 1e-4 and mean |diff| 1e-5.

The issue-rate probe's plain chains (tools/roofline.py) against the JAX
package's tools/vpu_roofline.py kernel body, run on jnp arrays at 64
trips: within a few ulp, per case (JAX_CHAIN_ULPS).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import make_scene as j_make_scene
from toypathtracer_tpu.ops.pallas_render import (_resolve_pix_per_lane,
                                                  render_frame_pallas_stats)
from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.ops import cuda_render
from toypathtracer_torch.ops import tracecore as tc
from toypathtracer_torch.render.wavefront import (camera_scalars,
                                                  render_tile_plain,
                                                  warp_counters)
from toypathtracer_torch.tools import occupancy, roofline

torch.set_num_threads(1)

STATS_CFGS = {
    "unmerged": dict(width=128, height=16, samples_per_pixel=2,
                     max_depth=10, tile_h=8, tile_w=128),
    "merged_padded": dict(width=100, height=20, samples_per_pixel=2,
                          max_depth=10, tile_h=16, tile_w=128,
                          pix_per_lane=2, merged_wavefront=True),
}
# (share of pixels within 1e-4, mean |diff|) gates of the image
IMAGE_GATES = {"unmerged": (0.999, 5e-7), "merged_padded": (0.995, 1e-5)}


@pytest.fixture(scope="module", params=sorted(STATS_CFGS))
def jax_stats(request):
    kw = STATS_CFGS[request.param]
    img, rays, it, wk = render_frame_pallas_stats(
        j_make_scene(big=True), JConfig(**kw), jnp.int32(3), interpret=True)
    return request.param, (np.asarray(img), int(rays), np.asarray(it),
                           np.asarray(wk))


def test_render_frame_stats_matches_jax(jax_stats):
    name, (jimg, jrays, jit, jwk) = jax_stats
    kw = STATS_CFGS[name]
    img, rays, it, wk = cuda_render.render_frame_stats(
        make_scene(big=True), RenderConfig(**kw), 3, device="cpu")
    assert it.dtype == wk.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), jit)
    np.testing.assert_array_equal(wk.numpy(), jwk)
    assert int(rays) == jrays
    img = img.numpy()
    assert img.shape == jimg.shape and np.isfinite(img).all()
    d = np.abs(img - jimg)
    within, mean = IMAGE_GATES[name]
    assert (d.max(axis=-1) <= 1e-4).mean() >= within
    assert d.mean() <= mean


@pytest.mark.parametrize("tile_h,ppl", [(16, 1), (16, 2), (16, 3), (24, 3),
                                        (48, 2), (32, 4), (8, 2), (64, 8),
                                        (16, 0)])
def test_resolve_pix_per_lane_matches_jax(tile_h, ppl):
    kw = dict(tile_h=tile_h, tile_w=128, pix_per_lane=max(ppl, 1))
    for pad in ((0, 0), (4, 28)):
        assert (cuda_render.resolve_pix_per_lane(RenderConfig(**kw), *pad)
                == _resolve_pix_per_lane(JConfig(**kw), *pad))


def test_render_pixels_stats_leaves_image_and_work():
    scene = make_scene(big=True)
    cfg = RenderConfig(width=24, height=8, samples_per_pixel=3, max_depth=3)
    tab = cuda_render.pack_scene(scene)
    mat = torch.tensor(scene.mat_type)
    yy, xx = torch.meshgrid(torch.arange(8), torch.arange(24),
                            indexing="ij")
    args = (tab, mat, scene.emissive_ids, cfg, camera_scalars(scene, cfg),
            xx.reshape(-1), yy.reshape(-1), 5)
    col, work = tc.render_pixels(*args)
    col_s, work_s, trips = tc.render_pixels(*args, stats=True)
    for a, b in zip(col + tuple(work), col_s + tuple(work_s)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert torch.equal(trips.depths.sum(dim=1), trips.bounces)
    assert torch.equal(trips.bounces, work.traced)
    # depth 3 cuts samples off; a cutoff sample ran all its bounces
    assert int(trips.cutoffs.sum()) > 0
    assert bool((trips.last_cutoff <= trips.cutoffs).all())
    assert bool((trips.depths[trips.last_cutoff.bool(), -1] == 3).all())


def counters(b, c, l):
    z = torch.zeros(1, 1, dtype=torch.int32)
    return cuda_render.StatsCounters(
        *(torch.tensor(x, dtype=torch.int32) for x in (b, c, l)), z, z)


def test_tile_counters_hand_built():
    # a 16x2 frame in one 16x2 tile, 2 pixels a lane: lane (r, col) owns
    # rows r and r + 8 of column col
    b = np.arange(32).reshape(16, 2) % 7 + 1
    c = (np.arange(32).reshape(16, 2) % 3 == 0).astype(int)
    l = c * (np.arange(32).reshape(16, 2) % 2)
    cfg = RenderConfig(width=2, height=16, tile_h=16, tile_w=2,
                       pix_per_lane=2)
    it, wk = cuda_render.tile_counters(counters(b, c, l), cfg)
    lane = b[:8] + b[8:]
    assert it.tolist() == [[lane.max()]] and wk.tolist() == [[lane.sum()]]
    it, wk = cuda_render.tile_counters(
        counters(b, c, l), cfg.replace(merged_wavefront=True))
    lane = 1 + b[:8] + b[8:] + c[:8] + c[8:] - l[8:]
    assert it.tolist() == [[lane.max()]] and wk.tolist() == [[lane.sum()]]
    # K = 3 does not fit 16 rows: one pixel a lane, two tiles of 8 rows
    cfg = cfg.replace(tile_h=8, pix_per_lane=3)
    it, wk = cuda_render.tile_counters(counters(b, c, l), cfg)
    assert it.tolist() == [[b[:8].max()], [b[8:].max()]]
    assert wk.tolist() == [[b[:8].sum()], [b[8:].sum()]]


def test_warp_counters_hand_built():
    # a 13x3 image in a 16x3 grid: two block rows, one block column; the
    # launch covers 16x16 pixels in 8 warps of 2x16
    rng = np.random.default_rng(3)
    depths = torch.from_numpy(rng.integers(0, 11, (16, 3, 4)))
    it, wk = warp_counters(depths, 13, 3)
    assert it.shape == wk.shape == (8, 1)
    for r in range(8):
        d = depths[2 * r:2 * r + 2].clone()
        d[max(0, 13 - 2 * r):] = 0
        assert int(it[r, 0]) == int(d.reshape(-1, 4).amax(dim=0).sum())
        assert int(wk[r, 0]) == int(d.sum())
    assert int(it[-1, 0]) == 0 and int(it[-2, 0]) > 0


def test_render_tile_stats_is_the_render():
    scene = make_scene(big=True)
    cfg = RenderConfig(width=40, height=12, samples_per_pixel=1,
                       max_depth=4, tile_h=16, tile_w=128)
    before = dict(cuda_render.launches)
    img, rays, cnt = cuda_render.render_tile_stats(scene, cfg, 1)
    assert cuda_render.launches == before
    ref, rref = render_tile_plain(scene, cfg, 1, 0, 0, 12, 40)
    assert torch.equal(img, ref) and int(rays) == int(rref)
    assert cnt.bounces.shape == (16, 128) and cnt.warp_iters.shape == (8, 8)
    assert int(cnt.bounces[:12, :40].sum()) == int(cnt.warp_work.sum())


def test_occupancy_tool_cpu(tmp_path, capsys):
    path = tmp_path / "occ.json"
    out = occupancy.main(["--device", "cpu", "--width", "128", "--height",
                          "16", "--spp", "2", "--depth", "4", "--tile",
                          "8,128", "--out", str(path)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out == json.loads(path.read_text())
    # the JAX tool's keys (tools/occupancy.py), plus the warp block
    assert set(out) == {"device", "config", "rays", "tiles", "iters",
                        "work_lane_bounces", "occupancy", "iters_vs_ideal",
                        "img_mean", "warp"}
    assert out["device"] == "cpu" and out["tiles"] == 2
    assert 0 < out["occupancy"]["weighted"] <= 1
    assert 0 < out["warp"]["efficiency"] <= 1
    assert out["warp"]["work_sum"] == out["work_lane_bounces"]


@pytest.mark.parametrize("case", list(roofline.CASES))
def test_probe_wrappers_on_cpu_run_the_plain_version(case):
    before = dict(roofline.launches)
    out = roofline.issue_rate(case, torch.empty(512), trips=3)
    assert torch.equal(out, roofline.chains_plain(case, 3, 512))
    floor = roofline.launch_floor(torch.empty(256))
    assert torch.equal(floor, roofline.chains_plain("fma", 1, 256))
    assert roofline.launches == before
    with pytest.raises(ValueError):
        roofline.issue_rate(case, torch.empty(100))


def test_vs_plain_holds_every_thread():
    out = roofline.issue_rate("render_mix", torch.empty(3 * roofline.PERIOD),
                              trips=5)
    r = roofline.vs_plain("render_mix", 5, out)
    assert r["finite"] and r["max_abs_err"] == 0 and r["threads"] == 3072
    out[2 * roofline.PERIOD + 7] += 1e-3
    assert roofline.vs_plain("render_mix", 5, out)["max_rel_err"] > 1e-6
    out[-1] = float("nan")
    assert not roofline.vs_plain("render_mix", 5, out)["finite"]


@pytest.fixture(scope="module")
def vpu_roofline():
    """tools/vpu_roofline.py, imported without keeping the persistent
    compilation cache it turns on for its own runs."""
    import importlib.util
    from pathlib import Path

    import jax
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    path = Path(__file__).resolve().parents[1] / "tools" / "vpu_roofline.py"
    spec = importlib.util.spec_from_file_location("vpu_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    return mod


# most ulps between the port's plain chains and the TPU tool's jnp chain
# bodies at 64 trips: rounding only.  cmpsel, sqrt and div are correctly
# rounded on both sides (measured 0); XLA may or may not contract the fma
# case's multiply-add (measured 0) and contracts render_mix's (measured
# 4); lax.rsqrt is not 1 / correctly rounded sqrt (measured 2).
JAX_CHAIN_ULPS = {"fma": 4, "cmpsel": 0, "sqrt": 0, "div": 0, "rsqrt": 4,
                  "render_mix": 8}


@pytest.mark.parametrize("case", list(roofline.CASES))
def test_probe_chains_match_vpu_roofline(vpu_roofline, monkeypatch, case):
    # the TPU tool's own kernel body (its chains' set-up, the case's step
    # and the fold), run on jnp arrays at 64 trips over one period of the
    # probe's thread inputs
    body, ops, flops = vpu_roofline.CASES[case]
    assert (roofline.CASES[case].ops, roofline.CASES[case].flops) == (
        ops, flops)
    assert roofline.CHAINS == vpu_roofline.CHAINS
    monkeypatch.setattr(vpu_roofline, "K", 64)
    kernel, _ = vpu_roofline._mk_kernel(body, ops)
    x = roofline.thread_x(1024, "cpu")
    out = np.empty((8, 128), np.float32)
    kernel(jnp.asarray(x.numpy().reshape(8, 128)), out)
    want = roofline.chains_plain(case, 64, 1024).numpy().reshape(8, 128)
    assert np.isfinite(want).all()
    ulps = np.abs(out - want) / np.spacing(np.abs(want))
    assert ulps.max() <= JAX_CHAIN_ULPS[case], ulps.max()


def test_roofline_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(SystemExit, match="CUDA"):
        roofline.main([])
