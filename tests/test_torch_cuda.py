"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked `cuda`: these skip without a CUDA device.  On the H100 run them
without the JAX-side conftest (the card's machine has no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the gates of chip_smoke.py.  Render kernel: rays 5e-4
relative, mean |diff| 1e-3; measured on an H100 at 320x176: rays exact,
max |diff| 1.9e-6; its merged form (the main path's) bit-equal to the
per-thread form it replaced, K4 bit-equal to it, and at 600 spheres
against the plain version with the same gates.  Gradient kernel: rays
exact, d_packed per row within
1e-3 x the row's max |plain autograd| (its warp form also at 130
spheres; the replaying form measured on an H100 at 320x176: at most
4.9e-6), two launches bit-equal, the stats instances bit-equal to the
forms they measure; the soft instances (soft_silhouette_eps 0.05) with
the same gates, their images bit-equal to the hard instances'; the pool
instance (a table per warp in device memory) bit-equal to the warp form
on its grid at 46 and 130 spheres, at 600 against plain autograd; the
chunked instance (the scaled scene's gradient) at 2000 spheres against
plain autograd, its image bit-equal to the scaled render kernel's.  Scaled
kernels (n=3000, chunk
256): the traversal K5 and the shadow bitmask K6 equal to their plain
versions on all but 1e-5 of the rays, t within 1e-6 relative where the
ids agree; K5's cooperative form bit-equal (ids and t) to its per-thread
form on that scene and on the 100k-sphere one, K6's to its per-thread
form, at several sizes (and light counts), their counted instances
bit-equal to the timed ones; the scaled render kernel
at 64x32 with the render kernel's gates, and its warp-cooperative form
bit-equal to the per-lane form at 320x176 on the 100k-sphere scene; the
stats instances' images bit-equal to the timed ones and their counts of
the sphere tests the rays need within the rays gate of the plain
version's.  Stats render kernel (K2): image and rays bit-equal to the
render kernel's; per-pixel trip counts equal to the plain version's on
all but 1e-4 of the pixels, tile and warp counters equal wherever their
pixels' counts are; its merged form's image and rays bit-equal to the
merged K1's and its five counter planes equal to the per-thread form's
(at 600 spheres, past that form's cap, to the plain version's).
Issue-rate probe (T1):
each case at 64 trips within 1e-6 relative of its plain version; the
launch floor (T2) positive and finite.  The differentiable wavefront's
pair (K1's tape instance and the sweep over its tape): image and rays
bit-equal to K1's; the main path's sweep (csrc/wavesweep.cu) within 1e-4
x each row's max of the kept sweep (csrc/wavegrad.cu), two launches
bit-equal; the kept sweep's d_packed bit-equal to K3's warp form (the
pool sweep's to the pool form at 600 spheres); both per row within 1e-3 x
the row's max of plain autograd through the plain wavefront; the staged
tape instance's tape word for word the scalar instance's at every used
slot; the tape freed at the first backward and written again for a
retained graph's second; a tape that does not fit raises, and a tape
that fits asks the card for no free-memory count.  The scaled scene's
shadow query past 16
lights (K6 in groups of 16) against its plain version.
"""

import numpy as np
import pytest
import torch

from toypathtracer_torch import FLAG_PROGRESSIVE, RenderConfig, make_scene
from toypathtracer_torch.inverse import InverseRenderer
from toypathtracer_torch.ops import cuda_grad, cuda_render, cuda_scaled
from toypathtracer_torch.ops import tracecore as tc
from toypathtracer_torch.render.frame import RenderSession
from toypathtracer_torch.render.wavefront import (render_frame_plain,
                                                  render_tile_grad_plain,
                                                  render_tile_stats_plain)
from toypathtracer_torch.scaled import (ChunkTraversal, ChunkedScenePort,
                                        make_scaled_scene, pack_chunks,
                                        render_frame_scaled_plain)
from toypathtracer_torch.tools import (grad_stats, render_parts, roofline,
                                      sass_loops)
from toypathtracer_torch.tools.scenes import (crowded_scene,
                                              shadow_boundary_scene)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("big,light_sampling", [(True, True), (True, False),
                                                (False, True)])
def test_kernel_matches_plain(card, big, light_sampling):
    scene = make_scene(big=big).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=6,
                       do_light_sampling=light_sampling)
    before = cuda_render.launches["render"]
    img, rays = cuda_render.render_tile(scene, cfg, 3, 0, 0, 40, 96)
    assert cuda_render.launches["render"] == before + 1
    plain, prays = render_frame_plain(scene, cfg, 3)
    torch.cuda.synchronize()
    assert img.device.type == "cuda" and rays.dtype == torch.int64
    assert torch.isfinite(img).all()
    assert abs(int(rays) - int(prays)) <= 5e-4 * int(prays)
    assert float((img - plain).abs().mean()) <= 1e-3


def test_session_runs_on_the_card(card):
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=4)
    sess = RenderSession(make_scene(big=True), cfg, flags=FLAG_PROGRESSIVE)
    before = cuda_render.launches["render"]
    img, rays = sess.steps(0.0, 3)
    torch.cuda.synchronize()
    assert cuda_render.launches["render"] == before + 3
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    assert rays.shape == (3,) and int(rays.min()) > 0


@pytest.mark.parametrize("case", ["big", "big_no_nee", "small",
                                  "crowded_600"])
def test_merged_kernel_bit_equal_to_thread_kernel(card, case):
    """K1's merged form (the main path's) against the per-thread kernel it
    replaced: image and rays bit-equal, at 600 spheres (past the per-thread
    kernel's cap) against the plain version with K1's gates; K4's merged
    form bit-equal to K1's; the counted instance bit-equal to the timed
    one."""
    scene = (crowded_scene(extra=554) if case == "crowded_600"
             else make_scene(big=case != "small")).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=6,
                       do_light_sampling=case != "big_no_nee")
    before = dict(cuda_render.launches)
    img, rays = cuda_render.render_tile(scene, cfg, 3, 0, 0, 40, 96)
    img_c, rays_c, counts = cuda_render.render_tile_form(
        scene, cfg, 3, 0, 0, 40, 96, "merged", counted=True)
    img_l, rays_l = cuda_grad.render_tile_lockstep(scene, cfg, 3, 0, 0, 40,
                                                   96)
    if case == "crowded_600":
        ref, ref_rays = render_frame_plain(scene, cfg, 3)
    else:
        ref, ref_rays = cuda_render.render_tile_form(scene, cfg, 3, 0, 0, 40,
                                                     96, "thread")
    torch.cuda.synchronize()
    assert cuda_render.launches["render"] == before["render"] + 1
    assert torch.equal(img_c, img) and int(rays_c) == int(rays)
    assert torch.equal(img_l, img) and int(rays_l) == int(rays)
    assert 0 < counts["busy"] <= 32 * counts["iters"]
    assert 0 < counts["cycles_hit"] < counts["cycles"]
    if case == "crowded_600":
        assert torch.isfinite(img).all()
        assert abs(int(rays) - int(ref_rays)) <= 5e-4 * int(ref_rays)
        assert float((img - ref).abs().mean()) <= 1e-3
    else:
        assert torch.equal(img, ref) and int(rays) == int(ref_rays)


def test_thread_kernel_parts_instance_bit_equal(card):
    """The per-thread kernel's clocked instance computes what it does and
    counts cycles in every part; the per-thread lockstep kernel (K4's
    baseline) is bit-equal to it."""
    scene = make_scene(big=True).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=6)
    img, rays = cuda_render.render_tile_form(scene, cfg, 1, 0, 0, 40, 96,
                                             "thread")
    img_p, rays_p, parts = cuda_render.render_tile_form(
        scene, cfg, 1, 0, 0, 40, 96, "thread", counted=True)
    img_l, rays_l = cuda_grad.render_tile_lockstep_baseline(
        scene, cfg, 1, 0, 0, 40, 96)
    torch.cuda.synchronize()
    assert torch.equal(img_p, img) and int(rays_p) == int(rays)
    assert torch.equal(img_l, img) and int(rays_l) == int(rays)
    assert parts["samples"] == 96 * 40 * 2
    assert all(parts[k] > 0 for k in cuda_render.PART_FIELDS), parts


def test_render_parts_and_sass_tools_on_the_card(card, tmp_path):
    """tools.render_parts at a small size: each form's cycle shares lie in
    [0, 1] and cover its cycles, the merged loop's lane busy share in (0,
    1]; tools.sass_loops finds the per-thread kernel's loops, one of them
    with the sphere test's square root."""
    out = render_parts.main(["--width", "64", "--height", "32", "--spp",
                             "2", "--depth", "4", "--out",
                             str(tmp_path / "r.json")])
    for f in out["forms"]:
        sh = f["cycle_shares"]
        assert all(0.0 <= v <= 1.0 for v in sh.values()), sh
        assert abs(sum(sh.values()) - 1) < 1e-9
    assert 0 < out["forms"][1]["lane_busy_share"] <= 1
    sass = sass_loops.main(["--out", str(tmp_path / "s.json")])
    loops = sass["kernels"]["render_kernel<0>"]["loops"]
    assert any("MUFU.RSQ" in lp["mufu"] for lp in loops), loops


@pytest.mark.parametrize("big", [True, False])
def test_grad_kernel_matches_plain_autograd(card, big):
    scene = make_scene(big=big).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=4)
    g = torch.from_numpy(np.random.RandomState(0).rand(40, 96, 3)
                         .astype(np.float32)).to(card)
    before = dict(cuda_grad.launches)
    img, rays, d = cuda_grad.render_tile_grad(scene, cfg, 1, g, 0, 0, 40, 96)
    img2, _, d2 = cuda_grad.render_tile_grad(scene, cfg, 1, g, 0, 0, 40, 96)
    img_l, rays_l = cuda_grad.render_tile_lockstep(scene, cfg, 1, 0, 0, 40,
                                                   96)
    assert cuda_grad.launches["grad"] == before["grad"] + 2
    assert cuda_grad.launches["lockstep"] == before["lockstep"] + 1
    img_p, rays_p, d_p = render_tile_grad_plain(scene, cfg, 1, g, 0, 0, 40,
                                                96)
    torch.cuda.synchronize()
    assert int(rays) == int(rays_p) == int(rays_l)
    assert torch.equal(img_l, img) and torch.equal(d, d2)
    assert float((img - img_p).abs().mean()) <= 1e-3
    for r in range(14):
        scale = float(d_p[r].abs().max())
        assert float((d[r] - d_p[r]).abs().max()) <= 1e-3 * scale, r


def assert_rows_close(got, want, rtol):
    for r in range(want.shape[0]):
        scale = float(want[r].abs().max())
        assert float((got[r] - want[r]).abs().max()) <= rtol * scale, r


@pytest.mark.parametrize("crowded", [False, True], ids=["46", "130"])
def test_warp_grad_kernel_matches_plain_autograd(card, crowded):
    """K3's warp form at 46 spheres and at 130 (the replaying form takes 64):
    plain autograd per row within 1e-3 x the row's max, rays exact, two
    launches bit-equal, the image bit-equal to K4's."""
    scene = (crowded_scene() if crowded else make_scene(big=True)).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=4)
    g = torch.from_numpy(np.random.RandomState(4).rand(40, 96, 3)
                         .astype(np.float32)).to(card)
    args = (scene, cfg, 2, g, 0, 0, 40, 96)
    img, rays, d = cuda_grad.render_tile_grad_form(*args, "warp")
    _, _, d2 = cuda_grad.render_tile_grad_form(*args, "warp")
    img_l, rays_l = cuda_grad.render_tile_lockstep(scene, cfg, 2, 0, 0, 40,
                                                   96)
    img_p, rays_p, d_p = render_tile_grad_plain(*args)
    torch.cuda.synchronize()
    assert int(rays) == int(rays_p) == int(rays_l)
    assert torch.equal(d, d2) and torch.equal(img, img_l)
    assert float((img - img_p).abs().mean()) <= 1e-3
    assert_rows_close(d, d_p, 1e-3)
    if crowded:
        assert int((d[:, 64:].abs().sum(dim=0) > 0).sum()) >= 5


@pytest.mark.parametrize("form", ["replay", "warp"])
def test_grad_stats_instance_bit_equal_to_timed(card, form):
    """The stats instances compute what the timed instances do, bit for
    bit, and count cycles in each part they have."""
    scene = make_scene(big=True).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=4)
    g = torch.from_numpy(np.random.RandomState(6).rand(40, 96, 3)
                         .astype(np.float32)).to(card)
    args = (scene, cfg, 0, g, 0, 0, 40, 96)
    timed = cuda_grad.render_tile_grad_form(*args, form)
    *got, counts = cuda_grad.render_tile_grad_form(*args, form, stats=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(timed, got))
    parts = ["cycles_fwd", "cycles_adj", "cycles_zero", "cycles_reduce",
             "cycles_all", "adj_bounces"]
    parts += ["cycles_replay", "replay_bounces"] if form == "replay" else [
        "cycles_group", "adj_slots", "hit_groups", "hit_lanes"]
    assert all(counts[k] > 0 for k in parts), counts


def test_grad_stats_tool_on_the_card(card, tmp_path):
    """tools.grad_stats at a small size: both forms' cycle shares lie in
    [0, 1] and, with "other", cover the threads' cycles; the rays are the
    plain version's; the final sums were timed."""
    out = grad_stats.main(["--width", "64", "--height", "32", "--spp", "2",
                           "--depth", "4", "--out", str(tmp_path / "g.json")])
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=4)
    _, rays = render_frame_plain(make_scene(big=True).to(card), cfg, 0)
    assert [f["form"] for f in out["forms"]] == ["replay", "warp"]
    for f in out["forms"]:
        sh = f["cycle_shares"]
        assert all(0.0 <= v <= 1.0 for v in sh.values()), sh
        assert abs(sum(v for k, v in sh.items()
                       if k not in grad_stats.WITHIN_ADJ) - 1) < 1e-9
        assert f["rays"] == int(rays) and f["sum_ms"] > 0


@pytest.mark.parametrize("form", ["warp", "replay"])
@pytest.mark.parametrize("which", ["big", "shadow_boundary"])
def test_soft_grad_instances_match_plain_autograd(card, form, which):
    """K3's soft instances (soft_silhouette_eps 0.05): plain autograd with
    the estimator on per row within 1e-3 x the row's max, rays exact, the
    image bit-equal to the hard instance's, two launches bit-equal, and
    each launch counted as the form's soft launch."""
    scene = (make_scene(big=True) if which == "big"
             else shadow_boundary_scene()).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=4,
                       soft_silhouette_eps=0.05)
    g = torch.from_numpy(np.random.RandomState(5).rand(40, 96, 3)
                         .astype(np.float32)).to(card)
    args = (scene, cfg, 1, g, 0, 0, 40, 96)
    counter = cuda_grad.COUNTERS[form] + cuda_grad.SOFT_SUFFIX
    before = dict(cuda_grad.launches)
    img, rays, d = cuda_grad.render_tile_grad_form(*args, form)
    _, _, d2 = cuda_grad.render_tile_grad_form(*args, form)
    img_h, rays_h, d_h = cuda_grad.render_tile_grad_form(
        scene, cfg.replace(soft_silhouette_eps=0.0), 1, g, 0, 0, 40, 96,
        form)
    img_p, rays_p, d_p = render_tile_grad_plain(*args)
    torch.cuda.synchronize()
    assert cuda_grad.launches[counter] == before[counter] + 2
    assert int(rays) == int(rays_p) == int(rays_h)
    assert torch.equal(d, d2) and torch.equal(img, img_h)
    assert_rows_close(d, d_p, 1e-3)
    assert not torch.equal(d, d_h)


def test_soft_stats_instance_bit_equal_to_timed(card):
    """The warp form's soft stats instance computes what its timed soft
    instance does, bit for bit, and counts the soft scans' cycles."""
    scene = make_scene(big=True).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=4,
                       soft_silhouette_eps=0.05)
    g = torch.from_numpy(np.random.RandomState(6).rand(40, 96, 3)
                         .astype(np.float32)).to(card)
    args = (scene, cfg, 0, g, 0, 0, 40, 96)
    timed = cuda_grad.render_tile_grad_form(*args, "warp")
    *got, counts = cuda_grad.render_tile_grad_form(*args, "warp", stats=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(timed, got))
    assert counts["cycles_soft"] > 0
    assert counts["cycles_soft"] < counts["cycles_adj"]


@pytest.mark.parametrize("lockstep", [False, True])
def test_frame_diff_runs_one_forward_and_one_gradient_launch(card, lockstep):
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=4)
    scene = make_scene(big=True)
    alb = scene.albedo.clone().requires_grad_(True)
    before = dict(cuda_render.launches, **cuda_grad.launches)
    img, _ = cuda_grad.render_frame_diff(scene.replace(albedo=alb), cfg, 0,
                                         lockstep_primal=lockstep)
    img.sum().backward()
    torch.cuda.synchronize()
    fwd = "lockstep" if lockstep else "render"
    now = dict(cuda_render.launches, **cuda_grad.launches)
    assert now[fwd] == before[fwd] + 1
    assert now["grad"] == before["grad"] + 1
    assert alb.grad.device.type == "cpu" and torch.isfinite(alb.grad).all()
    assert float(alb.grad.abs().max()) > 0


def test_inverse_renderer_on_the_card(card):
    scene = make_scene(big=False)
    cfg = RenderConfig(width=64, height=16, samples_per_pixel=2, max_depth=4)
    target, _ = cuda_render.render_frame(scene, cfg, 0)
    alb = scene.albedo.clone()
    alb[0] = torch.tensor([0.2, 0.9, 0.9])
    inv = InverseRenderer(cfg, target, trainable=("albedo",),
                          learning_rate=5e-2)
    fitted, losses = inv.fit(scene.replace(albedo=alb), steps=25,
                             resample=False)
    assert fitted.albedo.device.type == "cuda"
    assert losses[-1] < losses[0] * 0.3, losses


def random_rays(card, n, seed):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-30, 30, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.sqrt((d * d).sum(axis=0))
    return (tuple(torch.from_numpy(ro).to(card)),
            tuple(torch.from_numpy(d).to(card)))


def test_hit_chunks_kernel_matches_plain(card):
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0).to(card)
    ro, rd = random_rays(card, 8192, 5)
    before = cuda_scaled.launches["hit_chunks"]
    t, hid = ChunkedScenePort(scene).hit_chunks(ro, rd, 1e-3, 1e7)
    assert cuda_scaled.launches["hit_chunks"] == before + 1
    tp, idp, _, _ = ChunkTraversal(pack_chunks(scene), 256).nearest_hit(
        ro, rd, float(np.float32(1e-3)), 1e7)
    torch.cuda.synchronize()
    agree = hid.long() == idp
    assert int((~agree).sum()) <= 1e-5 * hid.numel()
    rel = ((t - tp).abs() / tp.abs())[agree]
    assert float(rel.max()) <= 1e-6 and int((hid >= 0).sum()) > 100


@pytest.mark.parametrize("n,big", [(45, False), (8192, False),
                                   (4099, True), (65543, True)])
def test_coop_hit_kernel_bit_equal_to_thread_kernel(card, n, big):
    """K5's cooperative form (the main path's) against the per-thread
    form it replaced, on the 3072-sphere field and the 100k scene: ids and
    t bit-equal; both counted instances bit-equal to their timed forms,
    counting the plain version's sphere tests exactly (the thread form its
    slab tests too); the launch counters show which form ran."""
    if big:
        scene = make_scaled_scene(100_000).to(card)
        rng = np.random.default_rng(n)
        o = rng.uniform((-150.0, 0.5, -150.0), (150.0, 12.0, 150.0),
                        (n, 3)).astype(np.float32).T.copy()
        d = rng.normal(size=(3, n)).astype(np.float32)
        d /= np.sqrt((d * d).sum(axis=0))
        ro = tuple(torch.from_numpy(o).to(card))
        rd = tuple(torch.from_numpy(d).to(card))
    else:
        scene = make_scaled_scene(n=3000, chunk=256, extent=40.0).to(card)
        ro, rd = random_rays(card, n, n)
    K = scene.chunk
    port = ChunkedScenePort(scene)
    args = (port.rows, ro, rd, K, 1e-3, 1e7)
    before = dict(cuda_scaled.launches)
    t, hid = port.hit_chunks(ro, rd, 1e-3, 1e7)
    t_b, id_b = cuda_scaled.hit_chunks_form(*args, "thread")
    t_c, id_c, st = cuda_scaled.hit_chunks_form(
        *args, "coop", index=port.chunk_index, stats=True)
    t_bc, id_bc, st_t = cuda_scaled.hit_chunks_form(*args, "thread",
                                                    stats=True)
    _, idp, slabs, spheres, roots = ChunkTraversal(
        port.rows, K).nearest_hit_roots(ro, rd, float(np.float32(1e-3)), 1e7)
    torch.cuda.synchronize()
    after = {k: cuda_scaled.launches[k] - before[k] for k in before}
    assert after == {"scaled_render": 0, "scaled_render_lane": 0,
                     "scaled_render_stats": 0, "scaled_tape": 0,
                     "scaled_grad": 0, "scaled_grad_soft": 0,
                     "scaled_grad_baseline": 0,
                     "scaled_grad_baseline_soft": 0, "scaled_grad_stats": 0, "hit_chunks": 1,
                     "hit_chunks_baseline": 1, "hit_chunks_counted": 2,
                     "shadow_chunks": 0, "shadow_chunks_baseline": 0,
                     "shadow_chunks_counted": 0}

    def bits(x):
        return x.view(torch.int32)
    assert torch.equal(hid, id_b) and torch.equal(bits(t), bits(t_b))
    assert torch.equal(id_c, hid) and torch.equal(bits(t_c), bits(t))
    assert torch.equal(id_bc, id_b) and torch.equal(bits(t_bc), bits(t_b))
    assert int((hid.long() != idp).sum()) <= 1e-5 * n
    assert int((idp >= 0).sum()) > 0
    assert st["hit"]["need"] == st_t["hit"]["need"] == int(spheres.sum())
    assert st_t["hit"]["slabs"] == int(slabs.sum())
    assert 0 < int(roots.sum()) < int(spheres.sum())
    assert st["hit"]["lanes"] == st_t["hit"]["lanes"] == n
    assert st["groups"]["slabs"] == n * port.chunk_index.gbox.shape[0]
    assert st_t["groups"] == {"boxes": 0, "slabs": 0}
    assert 0 < st["hit"]["simt_efficiency"] <= 1


def test_shadow_chunks_kernel_matches_plain(card):
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0).to(card)
    ro, _ = random_rays(card, 8192, 3)
    lights = list(scene.emissive_ids)[:4]
    dirs, t_ls = [], []
    for e in lights:
        c = scene.center[e]
        d = tuple(c[a] - ro[a] for a in range(3))
        dirs.append(tc.normalize3(d))
        t_ls.append(tc.sphere_t(c[0], c[1], c[2], scene.radius[e] ** 2, ro,
                                dirs[-1], 1e-3)[0])
    rows = pack_chunks(scene)
    before = cuda_scaled.launches["shadow_chunks"]
    bits = cuda_scaled.shadow_chunks(rows, ro, tuple(x for l in dirs
                                                     for x in l),
                                     tuple(t_ls), 256, lights, 1e-3)
    assert cuda_scaled.launches["shadow_chunks"] == before + 1
    want, _, _ = ChunkTraversal(rows, 256).occlusion_bits(
        ro, dirs, t_ls, lights, float(np.float32(1e-3)))
    torch.cuda.synchronize()
    assert int((bits != want).sum()) <= 1e-5 * bits.numel()
    assert 0 < float((want != 0).double().mean()) < 1


def test_lights_visible_past_sixteen_lights_matches_plain(card):
    """ChunkedScenePort.lights_visible at 20 lights on a card: K6 in two
    launches (16 + 4 lights), each light's visibility against the plain
    version's on the CPU within K6's rays gate; a single shadow_chunks
    call on the card refuses 17 lights."""
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0)
    others = [i for i in range(scene.n_spheres)
              if i not in scene.emissive_ids]
    lights = list(scene.emissive_ids) + others[:12]
    rng = np.random.default_rng(20)
    n = 8192
    ro = tuple(rng.uniform(-30, 30, n).astype(np.float32) for _ in range(3))
    c = scene.center.numpy()
    dirs = []
    for e in lights:
        d = tuple(c[e, a] - ro[a] + rng.normal(0, 2, n).astype(np.float32)
                  for a in range(3))
        norm = np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
        dirs.append(tuple(x / norm for x in d))

    def on(dev):
        return (tuple(torch.from_numpy(x).to(dev) for x in ro),
                [tuple(torch.from_numpy(x).to(dev) for x in l)
                 for l in dirs])
    ro_d, dirs_d = on(card)
    port = ChunkedScenePort(scene.to(card))
    before = cuda_scaled.launches["shadow_chunks"]
    got = port.lights_visible(ro_d, dirs_d, lights, 1e-3, 1e7)
    torch.cuda.synchronize()
    assert cuda_scaled.launches["shadow_chunks"] == before + 2
    want = ChunkedScenePort(scene).lights_visible(*on("cpu"), lights, 1e-3,
                                                  1e7)
    assert len(got) == len(want) == 20
    for k, (g, w) in enumerate(zip(got, want)):
        assert int((g.cpu() != w).sum()) <= 1e-5 * n, k
    assert any(bool(w.any()) for w in want[16:])
    with pytest.raises(ValueError, match="at most 16"):
        cuda_scaled.shadow_chunks(
            port.rows, ro_d, tuple(x for l in dirs_d[:17] for x in l),
            tuple(ro_d[0] for _ in range(17)), 256, tuple(lights[:17]),
            1e-3)


def beacon_rays(scene, card, n, n_lights, seed):
    """n shadow rays of K6's layout toward the scene's first n_lights
    beacons from seeded origins over the field, t_l from each beacon's own
    root."""
    rng = np.random.default_rng(seed)
    ro = tuple(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))
               .to(card) for lo, hi in ((-30, 30), (0, 12), (-30, 30)))
    lights = list(scene.emissive_ids)[:n_lights]
    dirs, t_ls = [], []
    for e in lights:
        c = scene.center[e]
        jitter = torch.from_numpy(rng.normal(0, 1.5, (3, n)).astype(
            np.float32)).to(card)
        dirs.append(tc.normalize3(tuple(c[a] - ro[a] + jitter[a]
                                        for a in range(3))))
        t_ls.append(tc.sphere_t(c[0], c[1], c[2], scene.radius[e] ** 2, ro,
                                dirs[-1], 1e-3)[0])
    return ro, dirs, t_ls, lights


@pytest.mark.parametrize("n,n_lights", [(45, 8), (8192, 8), (20000, 3),
                                        (4099, 1)])
def test_coop_shadow_kernel_bit_equal_to_thread_kernel(card, n, n_lights):
    """K6's cooperative form (the main path's) against the per-thread form
    it replaced: bits equal; both counted instances bit-equal to their
    timed forms, counting every pair, the per-thread form the plain
    version's sphere tests within the rays gate; the launch counters show
    which form ran."""
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0).to(card)
    ro, dirs, t_ls, lights = beacon_rays(scene, card, n, n_lights, n)
    rows = pack_chunks(scene)
    flat = tuple(x for l in dirs for x in l)
    args = (rows, ro, flat, tuple(t_ls), 256, lights, 1e-3)
    before = dict(cuda_scaled.launches)
    bits = cuda_scaled.shadow_chunks(*args)
    base = cuda_scaled.shadow_chunks_form(*args, "thread")
    bits_c, st = cuda_scaled.shadow_chunks_form(*args, "coop", stats=True)
    base_c, st_t = cuda_scaled.shadow_chunks_form(*args, "thread",
                                                  stats=True)
    want, _, spheres = ChunkTraversal(rows, 256).occlusion_bits(
        ro, dirs, t_ls, lights, float(np.float32(1e-3)))
    torch.cuda.synchronize()
    after = {k: cuda_scaled.launches[k] - before[k] for k in before}
    assert after == {"scaled_render": 0, "scaled_render_lane": 0,
                     "scaled_render_stats": 0, "scaled_tape": 0,
                     "scaled_grad": 0, "scaled_grad_soft": 0,
                     "scaled_grad_baseline": 0,
                     "scaled_grad_baseline_soft": 0, "scaled_grad_stats": 0, "hit_chunks": 0,
                     "hit_chunks_baseline": 0, "hit_chunks_counted": 0,
                     "shadow_chunks": 1, "shadow_chunks_baseline": 1,
                     "shadow_chunks_counted": 2}
    assert torch.equal(bits, base)
    assert torch.equal(bits_c, bits) and torch.equal(base_c, base)
    assert int((bits != want).sum()) <= 1e-5 * n
    assert 0 < float((want != 0).double().mean()) < 1
    need = int(spheres.sum())
    assert abs(st_t["shadow"]["need"] - need) <= 5e-4 * need
    assert 0 < st["shadow"]["need"] and 0 < st["shadow"]["slabs"]
    assert 0 < st["shadow"]["simt_efficiency"] <= 1
    assert st["shadow"]["lanes"] == st_t["shadow"]["lanes"] == n * n_lights


def test_scaled_render_kernel_matches_plain(card):
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0).to(card)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=4)
    before = cuda_scaled.launches["scaled_render"]
    img, rays = cuda_scaled.render_frame_scaled(scene, cfg, 1)
    assert cuda_scaled.launches["scaled_render"] == before + 1
    plain, prays = render_frame_scaled_plain(scene, cfg, 1)
    torch.cuda.synchronize()
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    assert abs(int(rays) - int(prays)) <= 5e-4 * int(prays)
    assert float((img - plain).abs().mean()) <= 1e-3


def test_scaled_session_runs_on_the_card(card):
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=4)
    sess = RenderSession(make_scaled_scene(n=3000, chunk=256, extent=40.0),
                         cfg, flags=FLAG_PROGRESSIVE)
    before = cuda_scaled.launches["scaled_render"]
    img, rays = sess.steps(0.0, 3)
    torch.cuda.synchronize()
    assert cuda_scaled.launches["scaled_render"] == before + 3
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    assert rays.shape == (3,) and int(rays.min()) > 0


@pytest.mark.parametrize("frame", [0, 1])
def test_scaled_render_forms_bit_equal(card, frame):
    scene = make_scaled_scene(100_000).to(card)
    cfg = RenderConfig(width=320, height=176, samples_per_pixel=1,
                       max_depth=4)
    before = dict(cuda_scaled.launches)
    img, rays = cuda_scaled.render_tile_scaled(scene, cfg, frame, 0, 0, 176,
                                               320)
    img_l, rays_l = cuda_scaled.render_tile_scaled_form(
        scene, cfg, frame, 0, 0, 176, 320, "lane")
    torch.cuda.synchronize()
    assert torch.equal(img_l, img) and int(rays_l) == int(rays)
    after = {k: cuda_scaled.launches[k] - before[k] for k in before}
    assert after == {"scaled_render": 1, "scaled_render_lane": 1,
                     "scaled_render_stats": 0, "scaled_tape": 0,
                     "scaled_grad": 0, "scaled_grad_soft": 0,
                     "scaled_grad_baseline": 0,
                     "scaled_grad_baseline_soft": 0, "scaled_grad_stats": 0, "hit_chunks": 0,
                     "hit_chunks_baseline": 0, "hit_chunks_counted": 0,
                     "shadow_chunks": 0, "shadow_chunks_baseline": 0,
                     "shadow_chunks_counted": 0}
    assert torch.isfinite(img).all() and int(rays) > 176 * 320


@pytest.mark.parametrize("form", ["lane", "coop"])
def test_scaled_stats_instance_matches_timed_and_plain(card, form):
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0).to(card)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=4)
    img, rays = cuda_scaled.render_tile_scaled_form(scene, cfg, 1, 0, 0, 32,
                                                    64, form)
    img_s, rays_s, st = cuda_scaled.render_tile_scaled_form(
        scene, cfg, 1, 0, 0, 32, 64, form, stats=True)
    _, _, lane = cuda_scaled.render_tile_scaled_form(
        scene, cfg, 1, 0, 0, 32, 64, "lane", stats=True)
    _, prays, plain = cuda_scaled.render_tile_scaled_form(
        scene.to("cpu"), cfg, 1, 0, 0, 32, 64, form, stats=True)
    torch.cuda.synchronize()
    assert torch.equal(img_s, img) and int(rays_s) == int(rays)
    # the plain version's paths agree within the rays gate here, its counts
    # within the same
    assert abs(int(rays) - int(prays)) <= 5e-4 * int(prays)
    assert st["hit"]["need"] == lane["hit"]["need"]
    assert abs(st["hit"]["need"] - plain["hit"]["need"]) <= \
        5e-4 * plain["hit"]["need"]
    for kind in ("hit", "shadow"):
        assert 0 < st[kind]["simt_efficiency"] <= 1
    if form == "lane":
        assert abs(st["shadow"]["need"] - plain["shadow"]["need"]) <= \
            5e-4 * plain["shadow"]["need"]
        slabs = st["hit"]["slabs"] + st["shadow"]["slabs"]
        assert abs(slabs - plain["slabs"]) <= 5e-4 * plain["slabs"]
    else:
        assert st["loop"]["busy"] <= 32 * st["loop"]["iters"]
        assert 0 < st["loop"]["cycles_hit"] < st["loop"]["cycles"]


@pytest.mark.parametrize("kw", [
    dict(tile_h=16, tile_w=128),
    dict(tile_h=32, tile_w=128, pix_per_lane=2, merged_wavefront=True)])
def test_stats_kernel_matches_render_kernel_and_plain(card, kw):
    scene = make_scene(big=True).to(card)
    cfg = RenderConfig(width=100, height=40, samples_per_pixel=2,
                       max_depth=6, **kw)
    before = cuda_render.launches["render_stats"]
    img, rays, cnt = cuda_render.render_tile_stats(scene, cfg, 1)
    assert cuda_render.launches["render_stats"] == before + 1
    img1, rays1 = cuda_render.render_tile(scene, cfg, 1, 0, 0, 40, 100)
    _, prays, pcnt = render_tile_stats_plain(scene, cfg, 1)
    torch.cuda.synchronize()
    assert torch.equal(img, img1) and int(rays) == int(rays1)
    assert abs(int(rays) - int(prays)) <= 5e-4 * int(prays)
    bad = torch.zeros_like(cnt.bounces, dtype=torch.bool)
    for k, p in zip(cnt[:3], pcnt[:3]):
        bad |= k != p
    assert float(bad.double().mean()) <= 1e-4
    if not bool(bad.any()):
        for k, p in zip(cuda_render.tile_counters(cnt, cfg),
                        cuda_render.tile_counters(pcnt, cfg)):
            assert torch.equal(k, p)
        assert torch.equal(cnt.warp_iters, pcnt.warp_iters)
        assert torch.equal(cnt.warp_work, pcnt.warp_work)


@pytest.mark.parametrize("case", ["16x128", "32x128_ppl2", "crowded_600"])
def test_merged_stats_kernel_matches_thread_form(card, case):
    """K2's merged form (the main path's): image and rays bit-equal to the
    merged K1's, and the five counter planes equal to the per-thread form's
    (render_kernel<1>) over the padded grid, frames 0-1; at 600 spheres,
    past that form's cap, against the plain version with the K2 gates
    (trip counts on all but 1e-3 of the pixels, the warp counters wherever
    their pixels' counts agree).  The launch counters show which form
    ran."""
    kw = {"16x128": dict(tile_h=16, tile_w=128),
          "32x128_ppl2": dict(tile_h=32, tile_w=128, pix_per_lane=2,
                              merged_wavefront=True),
          "crowded_600": dict(tile_h=16, tile_w=128)}[case]
    scene = (crowded_scene(extra=554) if case == "crowded_600"
             else make_scene(big=True)).to(card)
    cfg = RenderConfig(width=100, height=40, samples_per_pixel=2,
                       max_depth=6, **kw)
    for frame in (0, 1):
        before = dict(cuda_render.launches)
        img, rays, cnt = cuda_render.render_tile_stats(scene, cfg, frame)
        img1, rays1 = cuda_render.render_tile(scene, cfg, frame, 0, 0, 40,
                                              100)
        if case == "crowded_600":
            _, _, ref = render_tile_stats_plain(scene, cfg, frame)
        else:
            img_t, rays_t, ref = cuda_render.render_tile_stats_form(
                scene, cfg, frame, "thread")
        torch.cuda.synchronize()
        after = {k: cuda_render.launches[k] - before[k] for k in before}
        assert after == {"render": 1, "render_baseline": 0,
                         "render_counted": 0, "render_stats": 1,
                         "render_stats_baseline": int(case != "crowded_600")}
        assert torch.equal(img, img1) and int(rays) == int(rays1)
        assert int(cnt.warp_iters.sum()) > 0
        if case != "crowded_600":
            assert torch.equal(img_t, img) and int(rays_t) == int(rays)
            for got, want in zip(cnt, ref):
                assert got.shape == want.shape and torch.equal(got, want)
            continue
        bad = torch.zeros_like(cnt.bounces, dtype=torch.bool)
        for k, p in zip(cnt[:3], ref[:3]):
            bad |= k != p
        assert float(bad.double().mean()) <= 1e-3
        wr, wc = cnt.warp_iters.shape
        wbad = torch.zeros((2 * wr, 16 * wc), dtype=torch.bool, device=card)
        wbad[:bad.shape[0], :bad.shape[1]] = bad
        ok = ~wbad.reshape(wr, 2, wc, 16).any(3).any(1)
        assert torch.equal(cnt.warp_iters[ok], ref.warp_iters[ok])
        assert torch.equal(cnt.warp_work[ok], ref.warp_work[ok])


@pytest.mark.parametrize("case", list(roofline.CASES))
def test_probe_kernel_matches_plain(card, case):
    out = torch.empty(8 * 256, device=card)
    before = roofline.launches["issue_rate"]
    roofline.issue_rate(case, out, trips=64)
    assert roofline.launches["issue_rate"] == before + 1
    want = roofline.chains_plain(case, 64, out.numel(), card)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert float(((out - want).abs() / want.abs()).max()) <= 1e-6


def test_launch_floor_is_positive_and_finite(card):
    out = torch.empty(roofline.grid_blocks(1) * 256, device=card)
    busy = torch.empty(roofline.grid_blocks(4) * 256, device=card)
    ev = roofline.queued_event_s(lambda: roofline.launch_floor(out),
                                 lambda: roofline.issue_rate("fma", busy),
                                 8, 3)
    host = roofline.best_host_s(lambda: roofline.launch_floor(out), 3)
    assert 0 < ev < 1 and 0 < host < 1
    assert torch.equal(out[:256], roofline.chains_plain("fma", 1, 256, card))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("case", ["big", "crowded"])
def test_pool_grad_instance_bit_equal_to_warp_form(card, case, soft):
    """K3's pool instance (a table per warp in device memory) on the warp
    form's grid at 46 and 130 spheres: image, rays and d_packed bit-equal
    to the warp form's, and counted as the pool form's launch."""
    scene = (make_scene(big=True) if case == "big"
             else crowded_scene()).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=4,
                       soft_silhouette_eps=0.05 if soft else 0.0)
    g = torch.from_numpy(np.random.RandomState(5).rand(40, 96, 3)
                         .astype(np.float32)).to(card)
    args = (scene, cfg, 1, g, 0, 0, 40, 96)
    rows, _ = cuda_grad.grad_scratch(scene, cfg, 1, 0, 0, 40, 96, "warp")
    counter = "grad_pool" + ("_soft" if soft else "")
    before = cuda_grad.launches[counter]
    img, rays, d = cuda_grad.render_tile_grad_form(*args, "warp")
    p_img, p_rays, p_d = cuda_grad.render_tile_grad_form(*args, "pool",
                                                         blocks=rows)
    torch.cuda.synchronize()
    assert cuda_grad.launches[counter] == before + 1
    assert torch.equal(p_img, img) and int(p_rays) == int(rays)
    assert torch.equal(p_d, d)


def test_pool_grad_instance_past_512_spheres(card):
    """render_tile_grad takes the pool form past 512 spheres on a card:
    600 spheres against plain autograd per row within 1e-3, rays exact,
    two launches bit-equal, and a training step runs."""
    scene = crowded_scene(extra=554).to(card)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=4)
    g = torch.from_numpy(np.random.RandomState(7).rand(32, 64, 3)
                         .astype(np.float32)).to(card)
    args = (scene, cfg, 0, g, 0, 0, 32, 64)
    before = cuda_grad.launches["grad_pool"]
    img, rays, d = cuda_grad.render_tile_grad(*args)
    _, _, d2 = cuda_grad.render_tile_grad(*args)
    img_p, rays_p, d_p = render_tile_grad_plain(*args)
    torch.cuda.synchronize()
    assert cuda_grad.launches["grad_pool"] == before + 2
    assert int(rays) == int(rays_p) and torch.equal(d, d2)
    assert_rows_close(d, d_p, 1e-3)
    assert float((img - img_p).abs().max()) <= 1e-4
    target, _ = cuda_render.render_frame(scene, cfg, 0)
    inv = InverseRenderer(cfg, target * 0.9, trainable=("albedo",),
                          learning_rate=1e-2)
    _, losses = inv.fit(scene, steps=2, resample=False)
    assert all(np.isfinite(losses))


def test_pool_grad_instance_reruns_where_its_pool_runs_out(card):
    """A pool launch whose first capacity is too small runs again with as
    many slots and directory blocks as its warps drew (a third time where
    the blocks it dropped hid slots), and gives the result of a launch
    that had room (bit for bit)."""
    scene = crowded_scene(extra=554).to(card)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=3)
    g = torch.from_numpy(np.random.RandomState(3).rand(32, 64, 3)
                         .astype(np.float32)).to(card)
    mat, lights, cam = cuda_render.kernel_inputs(scene, cfg)
    tab = cuda_render.pack_scene(scene).contiguous()
    params = cuda_render.render_params(scene, cfg, 0, 0, 0, 32, 64)
    want = cuda_grad.launch_pool(tab, mat, lights, cam, params, g, card)
    room = dict(cuda_grad.last_pool)
    got = cuda_grad.launch_pool(tab, mat, lights, cam, params, g, card,
                                cap=16)
    torch.cuda.synchronize()
    assert room["launches"] == 1 and room["slots"] > 16
    assert cuda_grad.last_pool["launches"] in (2, 3)
    assert (cuda_grad.last_pool["slots"] == room["slots"]
            <= cuda_grad.last_pool["cap"])
    assert (cuda_grad.last_pool["dir_blocks"] == room["dir_blocks"]
            <= min(room["slots"], cuda_grad.last_pool["block_cap"]))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("eps", [0.0, 1.0], ids=["hard", "soft"])
def test_chunked_grad_instance_matches_plain_autograd(card, eps):
    """K3's chunked instance on tests/test_scaled.py:129's scene (2000
    spheres, chunk 64) at 64x32, spp 1, depth 3: plain autograd through
    the chunk traversal per row within 1e-3 (the soft instance 2e-3: one
    pixel's grazing hit makes the estimator's gradient move by more than
    that with one ulp of a centre, tests/test_torch_grad_kernel_cpu.py::
    test_chunked_soft_gradient_is_ill_conditioned_at_a_grazing_hit;
    measured 1.04e-3 on an H100 and with g++), rays exact, the image
    bit-equal to the scaled render kernel's, two launches bit-equal, the
    per-lane chunked instance's cotangent bit for bit, and the differentiable
    route one tape-writing render and one sweep launch whose gradient is
    the kernel's."""
    scene = make_scaled_scene(n=2000, chunk=64, extent=40.0).to(card)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=3,
                       soft_silhouette_eps=eps)
    g = torch.from_numpy(np.random.RandomState(0).rand(32, 64, 3)
                         .astype(np.float32)).to(card)
    args = (scene, cfg, 0, g, 0, 0, 32, 64)
    img, rays, d = cuda_scaled.render_tile_scaled_grad(*args)
    _, _, d2 = cuda_scaled.render_tile_scaled_grad(*args)
    want, want_rays = cuda_scaled.render_tile_scaled(scene, cfg, 0, 0, 0, 32,
                                                     64)
    from toypathtracer_torch.scaled import render_tile_scaled_grad_plain
    img_p, rays_p, d_p = render_tile_scaled_grad_plain(*args)
    img_b, rays_b, d_b = cuda_scaled.render_tile_scaled_grad_form(*args,
                                                                  "chunk")
    torch.cuda.synchronize()
    assert int(rays) == int(rays_p) == int(want_rays) == int(rays_b)
    assert torch.equal(img, want) and torch.equal(d, d2)
    assert torch.equal(img_b, img) and torch.equal(d_b, d)
    assert_rows_close(d, d_p, 2e-3 if eps else 1e-3)
    counter = "scaled_grad" + ("_soft" if eps else "")
    before = dict(cuda_scaled.launches)
    leaf = scene.albedo.clone().requires_grad_(True)
    out, _ = cuda_scaled.render_frame_scaled(scene.replace(albedo=leaf), cfg,
                                             0, differentiable=True)
    (out * g).sum().backward()
    after = {k: cuda_scaled.launches[k] - before[k] for k in before}
    assert after["scaled_render"] == 0 and after["scaled_tape"] == 1
    assert after[counter] == 1
    assert torch.equal(out.detach(), want)
    torch.testing.assert_close(leaf.grad.t(), d[6:9], rtol=0, atol=0)


def test_scaled_autograd_across_steps_and_a_retained_graph(card):
    """The differentiable scaled route keeps the forward's tape for its
    backward.  Two Adam steps on the albedo (2000 spheres, chunk 64,
    64x32, spp 1, depth 3): each launches one tape-writing render and one
    sweep, its gradient bit-equal to render_tile_scaled_grad's at that
    step's albedo.  Two losses on one render (retain_graph=True): the
    second backward writes the tape again (the first freed it) and each
    gets its own weights' cotangent bit for bit."""
    scene = make_scaled_scene(n=2000, chunk=64, extent=40.0).to(card)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=3)
    rs = np.random.RandomState(4)
    g1, g2 = (torch.from_numpy(rs.rand(32, 64, 3).astype(np.float32))
              .to(card) for _ in range(2))

    def want(albedo, g):
        return cuda_scaled.render_tile_scaled_grad(
            scene.replace(albedo=albedo.detach().clone()), cfg, 0, g, 0, 0,
            32, 64)[2][6:9].t()

    def launched(before):
        return {k: v - before[k] for k, v in cuda_scaled.launches.items()
                if v != before[k]}
    albedo = scene.albedo.clone().requires_grad_(True)
    opt = torch.optim.Adam([albedo], lr=1e-2)
    for _ in range(2):
        d = want(albedo, g1)
        before = dict(cuda_scaled.launches)
        img, _ = cuda_scaled.render_frame_scaled(
            scene.replace(albedo=albedo), cfg, 0, differentiable=True)
        opt.zero_grad()
        (img * g1).sum().backward()
        assert launched(before) == {"scaled_tape": 1, "scaled_grad": 1}
        assert torch.equal(albedo.grad, d)
        opt.step()
    d1, d2 = want(albedo, g1), want(albedo, g2)
    img, _ = cuda_scaled.render_frame_scaled(
        scene.replace(albedo=albedo), cfg, 0, differentiable=True)
    before = dict(cuda_scaled.launches)
    a1, = torch.autograd.grad((img * g1).sum(), albedo, retain_graph=True)
    a2, = torch.autograd.grad((img * g2).sum(), albedo)
    assert launched(before) == {"scaled_tape": 1, "scaled_grad": 2}
    assert torch.equal(a1, d1) and torch.equal(a2, d2)


@pytest.mark.parametrize("eps", [0.0, 0.05], ids=["hard", "soft"])
def test_forty_lights_on_the_card(card, eps):
    """40 lights: K3's warp form (its instance with the seen lights in
    words of their own) and pool form on tools/scenes.many_lights_scene
    at 64x32, spp 1, depth 3, and the scaled scene with emissive ids 0-39
    through the scaled render kernel and the cooperative chunked gradient:
    rays exact, per row within 1e-3 of plain autograd, the warp and pool
    forms bit-equal on the warp form's grid, the scaled gradient's image
    bit-equal to the scaled render kernel's."""
    from toypathtracer_torch.scaled import render_tile_scaled_grad_plain
    from toypathtracer_torch.tools.scenes import many_lights_scene
    scene = many_lights_scene().to(card)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=3,
                       soft_silhouette_eps=eps)
    g = torch.from_numpy(np.random.RandomState(2).rand(32, 64, 3)
                         .astype(np.float32)).to(card)
    args = (scene, cfg, 0, g, 0, 0, 32, 64)
    img, rays, d = cuda_grad.render_tile_grad_form(*args, "warp")
    rows, _ = cuda_grad.grad_scratch(scene, cfg, 0, 0, 0, 32, 64, "warp")
    img_q, rays_q, d_q = cuda_grad.render_tile_grad_form(*args, "pool",
                                                         blocks=rows)
    img_p, rays_p, d_p = render_tile_grad_plain(*args)
    torch.cuda.synchronize()
    assert int(rays) == int(rays_p) == int(rays_q)
    assert torch.equal(img, img_q) and torch.equal(d, d_q)
    assert_rows_close(d, d_p, 1e-3)
    ss = make_scaled_scene(n=2000, chunk=64, extent=40.0).to(card)
    ss = ss.replace(emissive_ids=tuple(range(40)))
    sargs = (ss, cfg, 0, g, 0, 0, 32, 64)
    want, want_rays = cuda_scaled.render_tile_scaled(ss, cfg, 0, 0, 0, 32,
                                                     64)
    img_s, rays_s, d_s = cuda_scaled.render_tile_scaled_grad(*sargs)
    img_sp, rays_sp, d_sp = render_tile_scaled_grad_plain(*sargs)
    torch.cuda.synchronize()
    assert int(rays_s) == int(want_rays) == int(rays_sp)
    assert torch.equal(img_s, want)
    assert_rows_close(d_s, d_sp, 2e-3 if eps else 1e-3)


def test_sharded_frames_on_one_card_are_bit_equal(card):
    """Four bands on one card (parallel/mesh): the frame and the scaled
    frame bit-equal to the single-device ones, one merged K1 / cooperative
    scaled render launch a band."""
    from toypathtracer_torch.parallel.mesh import (make_mesh,
                                                   render_frame_sharded)
    mesh = make_mesh([card] * 4)
    scene = make_scene(big=True).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=6)
    before = dict(cuda_render.launches)
    img, rays = render_frame_sharded(scene, cfg, 1, mesh)
    assert cuda_render.launches["render"] - before["render"] == 4
    want, want_rays = cuda_render.render_frame(scene, cfg, 1)
    assert torch.equal(img, want) and int(rays) == int(want_rays)
    ss = make_scaled_scene(n=3000, chunk=256, extent=40.0).to(card)
    before = dict(cuda_scaled.launches)
    img, rays = cuda_scaled.render_frame_scaled_sharded(ss, cfg, 0, mesh)
    assert (cuda_scaled.launches["scaled_render"]
            - before["scaled_render"]) == 4
    want, want_rays = cuda_scaled.render_frame_scaled(ss, cfg, 0)
    assert torch.equal(img, want) and int(rays) == int(want_rays)


@pytest.mark.parametrize("eps", [0.0, 0.05], ids=["hard", "soft"])
def test_sharded_step_on_one_card_matches_single_device(card, eps):
    """make_sharded_value_and_grad over four bands on one card: one render
    and one K3 launch a band, the loss within 1e-5 and each field within
    1e-5 x its max of the single-device step's."""
    from toypathtracer_torch.inverse import (make_sharded_value_and_grad,
                                             render_loss)
    from toypathtracer_torch.parallel.mesh import make_mesh
    scene = make_scene(big=True).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=4,
                       soft_silhouette_eps=eps)
    target = torch.zeros((40, 96, 3), device=card)
    before = dict(cuda_grad.launches)
    loss, grads = make_sharded_value_and_grad(cfg, make_mesh([card] * 4))(
        scene, target, 0)
    key = "grad_soft" if eps else "grad"
    assert cuda_grad.launches[key] - before[key] == 4
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in cuda_grad.PARAM_FIELDS}
    l1 = render_loss(scene.replace(**leaves), target, cfg, 0)
    g1 = torch.autograd.grad(l1, list(leaves.values()))
    l1 = l1.detach()
    assert abs(float(loss) - float(l1)) <= 1e-5 * abs(float(l1))
    for f, want in zip(cuda_grad.PARAM_FIELDS, g1):
        assert float((grads[f] - want).abs().max()) <= \
            1e-5 * float(want.abs().max()) + 1e-12, f


def golden(name):
    """A golden of the reference's compiled C++ (tests/golden), read
    without the JAX-side conftest."""
    import pathlib
    path = pathlib.Path(__file__).resolve().parent / "golden" / f"{name}.npz"
    with np.load(path) as g:
        return {k: g[k] for k in g.files}


def test_parity_on_the_card_against_the_goldens(card):
    """The parity renderer on the card (CUDA's sinf/cosf) at
    tests/test_parity.py's gates: tiny_f1 and the depth-2 per-pixel
    golden; no counted kernel launched."""
    from toypathtracer_torch.render.parity import (render_frame_parity,
                                                   render_frame_parity_pp)
    scene = make_scene(big=True)
    before = {**cuda_render.launches, **cuda_grad.launches}
    img, rays = render_frame_parity(scene, RenderConfig(width=64, height=36),
                                    0)
    assert img.is_cuda
    a, g = img.cpu().numpy(), golden("tiny_f1")
    d = np.abs(a - g["image"]).max(axis=-1)
    np.testing.assert_allclose(a[0, 0], g["image"][0, 0], atol=2e-5)
    assert np.median(d[:, 0]) < 1e-3 and np.median(d) < 0.02
    assert (d < 1e-3).mean() > 0.25
    assert abs(int(rays) - int(g["rays"])) / int(g["rays"]) < 0.02
    img, rays = render_frame_parity_pp(
        scene, RenderConfig(width=64, height=36, max_depth=2), 0)
    g = golden("tiny_pp_d2_f1")
    d = np.abs(img.cpu().numpy() - g["image"]).max(axis=-1)
    assert (d >= 2e-4).mean() <= 0.0 and np.median(d) < 5e-7
    assert abs(int(rays) - int(g["rays"])) / int(g["rays"]) < 2e-3
    assert {**cuda_render.launches, **cuda_grad.launches} == before


def test_resume_bit_exact_on_the_card(card, tmp_path):
    """A progressive session resumed from its saved frame state, and a fit
    resumed from its saved train state, equal the uninterrupted runs bit
    for bit (K1; K1 and K3's warp form)."""
    from toypathtracer_torch import checkpoint as ckpt
    cfg = RenderConfig(width=320, height=176, samples_per_pixel=2,
                       max_depth=6)
    scene = make_scene(big=True)
    sess = RenderSession(scene, cfg, device="cuda")
    for _ in range(3):
        sess.step(0.0)
    path = str(tmp_path / "frame.npz")
    ckpt.save_frame_state(path, sess.state)
    for _ in range(2):
        live, _ = sess.step(0.0)
    live = live.clone()
    resumed = RenderSession(scene, cfg, device="cuda")
    resumed.state = ckpt.load_frame_state(path)
    for _ in range(2):
        img, _ = resumed.step(0.0)
    assert resumed.state.frame == 5 and torch.equal(img, live)

    small = RenderConfig(width=64, height=32, samples_per_pixel=2,
                         max_depth=4)
    target, _ = cuda_render.render_frame(scene, small, 0)
    start = scene.replace(albedo=scene.albedo * 0.7)

    def renderer():
        return InverseRenderer(small, target, trainable=("albedo", "center"),
                               learning_rate=0.02)
    before = cuda_grad.launches["grad"]
    straight, losses = renderer().fit(start, 4)
    assert cuda_grad.launches["grad"] - before == 4
    r = renderer()
    half, first = r.fit(start, 2)
    tpath = str(tmp_path / "train")
    ckpt.save_train_state(tpath, half, r.opt_state, step=2)
    loaded, state, step = ckpt.load_train_state(tpath)
    assert loaded.center.is_cuda and state["albedo"][0].is_cuda
    back, second = renderer().fit(loaded, 2, frame0=step, opt_state=state)
    assert first + second == losses
    for f in cuda_grad.PARAM_FIELDS:
        assert torch.equal(getattr(back, f), getattr(straight, f)), f


def test_viewer_batch_matches_single_steps_on_the_card(card):
    """Viewer(batch=4) on the card: one step renders 4 frames through 4
    K1 launches, bit-equal to 4 single steps; the 'g' switch to the plain
    renderer resets the accumulator on the card and launches no
    kernel."""
    from toypathtracer_torch.serve import Viewer
    cfg = RenderConfig(width=320, height=176, samples_per_pixel=2,
                       max_depth=6)
    fns = {"cuda": None, "plain": render_frame_plain}
    vb = Viewer(make_scene(big=True), cfg, render_fns=fns, batch=4)
    vs = Viewer(make_scene(big=True), cfg, render_fns=fns)
    vb.time_scale = vs.time_scale = 0.0
    before = cuda_render.launches["render"]
    vb.step_once()
    assert cuda_render.launches["render"] - before == 4
    for _ in range(4):
        vs.step_once()
    assert vb.sess.state.frame == vs.sess.state.frame == 4
    assert torch.equal(vb.sess.state.accum, vs.sess.state.accum)
    before = cuda_render.launches["render"]
    vs.set_backend("plain")
    vs.step_once()
    assert cuda_render.launches["render"] == before
    assert vs.sess.state.frame == 1 and vs.sess.state.accum.is_cuda


WAVE = dict(merged_wavefront=True, diff_wavefront=True)


@pytest.mark.parametrize("case", ["big", "crowded_600", "forty_lights"])
def test_wave_pair_bit_equal_to_k1_and_k3(card, case):
    """The differentiable wavefront's pair: K1's tape instance gives K1's
    image and rays bit for bit; the main path's sweep over its tape (the
    redesigned sweep, csrc/wavesweep.cu; at 600 spheres its pool instance)
    is within 1e-4 x each row's max of the kept sweep (csrc/wavegrad.cu
    wave_sweep_kernel, wave_sweep_pool_kernel), which gives K3's cotangent
    bit for bit on K3's grid (the warp form's, the pool form's), and per
    row within 1e-3 x the row's max of autograd through the plain
    wavefront; two launches bit-equal; one tape and one sweep launch, none
    of the kept sweep.  Of the sweeps only the kept one is K3's bit for
    bit: the main sweep takes its adds in another order."""
    from toypathtracer_torch.tools.scenes import many_lights_scene
    scene = {"big": make_scene(big=True), "crowded_600":
             crowded_scene(extra=554),
             "forty_lights": many_lights_scene()}[case].to(card)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=4,
                       **WAVE)
    g = torch.from_numpy(np.random.RandomState(9).rand(32, 64, 3)
                         .astype(np.float32)).to(card)
    args = (scene, cfg, 1, 0, 0, 32, 64)
    k1_img, k1_rays = cuda_render.render_tile(*args)
    pooled = scene.n_spheres > cuda_render.MAX_SPHERES
    form, sweep = ("pool", "wave_sweep_pool") if pooled else \
        ("warp", "wave_sweep")
    lock = cfg.replace(diff_wavefront=False)
    before = dict(cuda_grad.launches)
    img, rays, tape = cuda_grad.render_tile_wave_tape(*args)
    d = cuda_grad.sweep_wave_tape(scene, cfg, g, tape)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in cuda_grad.launches.items()
            if v != before[k]} == {"wave_tape": 1, sweep: 1}
    assert torch.equal(img, k1_img) and int(rays) == int(k1_rays)
    _, _, d_k3 = cuda_grad.render_tile_grad_form(scene, lock, 1, g, 0, 0, 32,
                                                 64, form)
    d_kept = cuda_grad.sweep_wave_tape(scene, cfg, g, tape, form="tiles")
    assert torch.equal(d_kept, d_k3)
    assert_rows_close(d, d_kept, 1e-4)
    assert torch.equal(cuda_grad.sweep_wave_tape(scene, cfg, g, tape), d)
    _, rays_p, d_p = render_tile_grad_plain(scene, cfg, 1, g, 0, 0, 32, 64)
    assert int(rays_p) == int(rays)
    assert_rows_close(d, d_p, 1e-3)


@pytest.mark.parametrize("case", ["big", "crowded_600", "forty_lights"])
def test_staged_tape_instance_equal_to_scalar_instance(card, case):
    """K1's staged tape instance (merged_render_kernel<4>, the main
    path's) against the instance it replaced (<3>): every word of every
    used slot (rec, see) and every sample's bounces equal; both images
    and rays K1's bit for bit; the kept sweep over the staged tape K3's
    cotangent bit for bit (the warp form's; the pool sweep the pool
    form's at 600 spheres); one launch of each instance."""
    from toypathtracer_torch.tools.scenes import many_lights_scene
    scene = {"big": make_scene(big=True), "crowded_600":
             crowded_scene(extra=554),
             "forty_lights": many_lights_scene()}[case].to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=3, max_depth=5,
                       **WAVE)
    g = torch.from_numpy(np.random.RandomState(3).rand(40, 96, 3)
                         .astype(np.float32)).to(card)
    args = (scene, cfg, 2, 0, 0, 40, 96)
    k1_img, k1_rays = cuda_render.render_tile(*args)
    before = dict(cuda_grad.launches)
    img_s, rays_s, staged = cuda_grad.render_tile_wave_tape(*args)
    img_b, rays_b, scalar = cuda_grad.render_tile_wave_tape(*args,
                                                            form="scalar")
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in cuda_grad.launches.items()
            if v != before[k]} == {"wave_tape": 1, "wave_tape_baseline": 1}
    assert torch.equal(img_s, k1_img) and int(rays_s) == int(k1_rays)
    assert torch.equal(img_b, k1_img) and int(rays_b) == int(k1_rays)
    assert torch.equal(staged["depth"], scalar["depth"])
    used = (torch.arange(cfg.max_depth, device=card)[None, :]
            < staged["depth"].long()[:, None]).reshape(-1)
    assert bool(used.any()) and not bool(used.all())
    words = -(-len(scene.emissive_ids) // 32)
    rec_s, rec_b = (t["rec"].view(torch.int32).reshape(-1, 16)[used]
                    for t in (staged, scalar))
    see_s, see_b = (t["see"].reshape(-1, words)[used]
                    for t in (staged, scalar))
    assert torch.equal(rec_s, rec_b) and torch.equal(see_s, see_b)
    form = "pool" if scene.n_spheres > cuda_render.MAX_SPHERES else "warp"
    d = cuda_grad.sweep_wave_tape(scene, cfg, g, staged, form="tiles")
    _, _, d_k3 = cuda_grad.render_tile_grad_form(
        scene, cfg.replace(diff_wavefront=False), 2, g, 0, 0, 40, 96, form)
    assert torch.equal(d, d_k3)
    with pytest.raises(ValueError, match="no tape instance"):
        cuda_grad.render_tile_wave_tape(*args, form="bogus")


@pytest.mark.parametrize("case,width,height,spp,depth", [
    ("big", 64, 32, 2, 4), ("big", 96, 40, 3, 10), ("big", 70, 21, 5, 3),
    ("forty_lights", 64, 32, 2, 4)])
def test_run_sweep_against_kept_sweep(card, case, width, height, spp, depth):
    """The redesigned sweep (csrc/wavesweep.cu wave_run_kernel, the main
    path's) on the tape of K1's staged instance: within 1e-4 x each row's
    max of the kept sweep (wave_sweep_kernel, K3's cotangent bit for bit
    on its grid), a sub-image whose edge tiles lie partly outside it
    included; two launches bit-equal; its loop on the kept sweep's deal,
    launch bounds and grid ("runs_on_tiles_deal") the kept sweep's bit for
    bit; both stats instances bit-equal to their timed instances, their
    lane slots and adjoint bounces consistent; the kept sweep has no stats
    instance; the launch counters: "wave_sweep" for the main sweep,
    "wave_sweep_baseline" for the kept one, "wave_sweep_tiles_deal" for
    the deal form."""
    from toypathtracer_torch.tools.scenes import many_lights_scene
    scene = {"big": make_scene(big=True),
             "forty_lights": many_lights_scene()}[case].to(card)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=depth, **WAVE)
    g = torch.from_numpy(np.random.RandomState(21).rand(height, width, 3)
                         .astype(np.float32)).to(card)
    _, _, tape = cuda_grad.render_tile_wave_tape(scene, cfg, 3, 0, 0, height,
                                                 width)
    before = dict(cuda_grad.launches)
    kept = cuda_grad.sweep_wave_tape(scene, cfg, g, tape, form="tiles")
    d = cuda_grad.sweep_wave_tape(scene, cfg, g, tape)
    d2 = cuda_grad.sweep_wave_tape(scene, cfg, g, tape)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in cuda_grad.launches.items()
            if v != before[k]} == {"wave_sweep": 2, "wave_sweep_baseline": 1}
    assert torch.equal(d, d2) and float(kept.abs().max()) > 0
    assert_rows_close(d, kept, 1e-4)
    _, _, d_k3 = cuda_grad.render_tile_grad_form(
        scene, cfg.replace(diff_wavefront=False), 3, g, 0, 0, height, width,
        "warp")
    assert torch.equal(kept, d_k3)
    before = dict(cuda_grad.launches)
    assert torch.equal(cuda_grad.sweep_wave_tape(
        scene, cfg, g, tape, form="runs_on_tiles_deal"), kept)
    assert cuda_grad.launches["wave_sweep_tiles_deal"] == before[
        "wave_sweep_tiles_deal"] + 1
    ds, c = cuda_grad.sweep_wave_tape(scene, cfg, g, tape, stats=True)
    ks, kc = cuda_grad.sweep_wave_tape(scene, cfg, g, tape,
                                       form="runs_on_tiles_deal", stats=True)
    assert torch.equal(ds, d) and torch.equal(ks, kept)
    assert c["adj_bounces"] == kc["adj_bounces"] > 0
    assert c["adj_slots"] >= c["adj_bounces"]
    assert c["cycles_all"] > c["cycles_adj"] > c["cycles_bounce"] > 0
    with pytest.raises(ValueError, match="no wavefront sweep"):
        cuda_grad.sweep_wave_tape(scene, cfg, g, tape, form="bogus")
    with pytest.raises(ValueError, match="no stats instance"):
        cuda_grad.sweep_wave_tape(scene, cfg, g, tape, form="tiles",
                                  stats=True)


def test_alloc_tape_queries_free_memory_only_when_it_fails(card,
                                                           monkeypatch):
    """alloc_tape allocates the tape directly: a tape that fits asks the
    card nothing (torch.cuda.mem_get_info is not called); one larger than
    the card raises MemoryError naming its bytes, the free memory and the
    band height to use instead, and leaves nothing allocated."""
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=4,
                       **WAVE)
    real = torch.cuda.mem_get_info
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(torch.cuda, "mem_get_info", counted)
    tape = cuda_grad.alloc_tape(2, cfg, 32, 64, card, "the route", "bands")
    assert tape["rec"].numel() == 32 * 64 * 2 * 4 * 16 and not calls
    del tape
    huge = cfg.replace(width=1280, height=720, samples_per_pixel=255,
                       max_depth=255)
    need = cuda_grad.tape_bytes(2, huge, 720, 1280)
    assert need > torch.cuda.get_device_properties(card).total_memory
    held = torch.cuda.memory_allocated(card)
    with pytest.raises(MemoryError) as err:
        cuda_grad.alloc_tape(2, huge, 720, 1280, card, "the route",
                             "render_tile_diff on sub-images")
    msg = str(err.value)
    assert f"takes {need} bytes" in msg and "free" in msg
    assert "bands of at most" in msg and "render_tile_diff" in msg
    assert calls and torch.cuda.memory_allocated(card) == held


def test_wave_autograd_across_steps_and_a_retained_graph(card):
    """Under cfg.diff_wavefront render_frame_diff on a card takes the pair
    with no warning: each step one tape and one sweep launch and no K3,
    its albedo gradient bit-equal to render_tile_grad's; two losses on one
    render (retain_graph=True): the second backward writes the tape again
    and each gets its own weights' cotangent bit for bit.  A tape that
    does not fit raises, naming its bytes."""
    import warnings
    scene = make_scene(big=True).to(card)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=4,
                       **WAVE)
    rs = np.random.RandomState(4)
    g1, g2 = (torch.from_numpy(rs.rand(32, 64, 3).astype(np.float32))
              .to(card) for _ in range(2))

    def want(albedo, g):
        return cuda_grad.render_tile_grad(
            scene.replace(albedo=albedo.detach().clone()), cfg, 0, g, 0, 0,
            32, 64)[2][6:9].t()

    def launched(before):
        return {k: v - before[k] for k, v in cuda_grad.launches.items()
                if v != before[k]}
    albedo = scene.albedo.clone().requires_grad_(True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d = want(albedo, g1)
        before = dict(cuda_grad.launches)
        img, _ = cuda_grad.render_frame_diff(scene.replace(albedo=albedo),
                                             cfg, 0)
        (img * g1).sum().backward()
    assert launched(before) == {"wave_tape": 1, "wave_sweep": 1}
    assert torch.equal(albedo.grad, d)
    d1, d2 = want(albedo, g1), want(albedo, g2)
    img, _ = cuda_grad.render_frame_diff(scene.replace(albedo=albedo), cfg, 0)
    before = dict(cuda_grad.launches)
    a1, = torch.autograd.grad((img * g1).sum(), albedo, retain_graph=True)
    a2, = torch.autograd.grad((img * g2).sum(), albedo)
    assert launched(before) == {"wave_tape": 1, "wave_sweep": 2}
    assert torch.equal(a1, d1) and torch.equal(a2, d2)
    huge = RenderConfig(width=1280, height=720, samples_per_pixel=255,
                        max_depth=255, **WAVE)
    with pytest.raises(MemoryError, match="bytes"):
        cuda_grad.render_tile_wave_tape(scene, huge, 0, 0, 0, 720, 1280)
