"""The scaled scene in the port (toypathtracer_torch/scaled.py and
ops/cuda_scaled.py on the CPU) against the JAX package's scaled.py and
ops/scaled_pallas.py.

Tolerances:
  * scene arrays: bit-equal (the same numpy construction); animated
    beacons within 1e-5 relative (torch and XLA cos/sin differ in the last
    bits), everything else bit-equal;
  * the traversal, against the jnp chunk scan and the Pallas kernels in
    interpret mode: ids and occlusion bits exactly equal; t within 2e-4
    relative.  XLA on the CPU contracts the root's products into FMAs
    (emulating that reproduces its t on 74% of hit lanes, the port's
    unfused arithmetic on 10%), and discr = nb^2 - c cancels (nb^2 ~
    3600 against r^2 ~ 0.1), so t differs on 90% of hit lanes, by up to
    8.9e-5 relative (measured).  The port's rounding is the CUDA
    kernels' (-fmad=false): tests/test_torch_scaled_kernel_cpu.py holds
    the two exactly;
  * the render against render_frame_scaled(pallas=False) at 48x16, spp 1,
    depth 3, n=800, chunk 128, frames 0-1: a 1-ulp transcendental
    difference (torch CPU vs XLA CPU) flips a few Monte-Carlo decisions,
    and with beacons of emission 10-40 a flipped pixel moves by up to
    0.2.  Measured: rays exact, 3 of 768 pixels beyond 1e-4, mean |diff|
    2.6e-4 (frame 0) and 2.1e-4 (frame 1).  Gates: rays within 1e-3
    relative, 98.5% of pixels within 1e-4 (tests/test_torch_frame.py's
    gate), mean |diff| <= 6e-4;
  * culling: bit for bit against a single chunk.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import scaled as jscaled
from toypathtracer_tpu.ops.scaled_pallas import (LANE_TILE, hit_chunks_tiles,
                                                 shadow_chunks_tiles)
from toypathtracer_torch import (FLAG_ANIMATE, FLAG_PROGRESSIVE,
                                 RenderConfig, ScaledScene,
                                 make_scaled_scene, scaled_scene_from_arrays)
from toypathtracer_torch.cli import main as cli_main
from toypathtracer_torch.ops import cuda_scaled
from toypathtracer_torch.render.frame import RenderSession
from toypathtracer_torch.scaled import (ChunkedScenePort, pack_chunks,
                                        render_frame_scaled_plain)

torch.set_num_threads(1)

FIELDS = ("center", "radius", "albedo", "emissive", "roughness", "ri",
          "mat_is_lam", "mat_is_met", "mat_is_die", "chunk_aabb")
CFG = RenderConfig(width=48, height=16, samples_per_pixel=1, max_depth=3)
JCFG = JConfig(width=48, height=16, samples_per_pixel=1, max_depth=3)


def to_jax_arrays(s):
    return {f: np.asarray(getattr(s, f)) for f in FIELDS}


def assert_bounds(scene: ScaledScene):
    K = scene.chunk
    c = scene.center.numpy().reshape(-1, K, 3)
    r = scene.radius.numpy().reshape(-1, K)
    aabb = scene.chunk_aabb.numpy()
    assert (c - r[..., None] >= aabb[:, None, :3]).all()
    assert (c + r[..., None] <= aabb[:, None, 3:]).all()


@pytest.mark.parametrize("kw", [dict(n=800, chunk=128),
                                dict(n=3000, chunk=256, extent=40.0),
                                dict(n=100_000)],
                         ids=["800", "3000", "100k"])
def test_scene_build_is_bit_equal(kw):
    s = make_scaled_scene(**kw)
    j = jscaled.make_scaled_scene(**kw)
    for f, want in to_jax_arrays(j).items():
        got = getattr(s, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (s.chunk, s.n_real, s.emissive_ids) == (j.chunk, j.n_real,
                                                   j.emissive_ids)
    assert s.camera.__dict__ == j.camera.__dict__
    assert_bounds(s)
    # the state carried across from the JAX scene is the same scene
    c = scaled_scene_from_arrays(**to_jax_arrays(j), chunk=j.chunk,
                                 n_real=j.n_real, emissive_ids=j.emissive_ids,
                                 camera=s.camera)
    for f in FIELDS:
        assert torch.equal(getattr(c, f), getattr(s, f)), f


def test_animate_matches_jax():
    s = make_scaled_scene(n=800, chunk=128, extent=30.0)
    j = jscaled.make_scaled_scene(n=800, chunk=128, extent=30.0)
    sa, ja = s.animate(1.3), j.animate(jnp.float32(1.3))
    nl = len(s.emissive_ids)
    got, want = sa.center.numpy(), np.asarray(ja.center)
    np.testing.assert_array_equal(got[nl:], want[nl:])
    np.testing.assert_allclose(got[:nl], want[:nl], rtol=1e-5, atol=0)
    assert not np.allclose(got[:nl], s.center.numpy()[:nl])
    assert_bounds(sa)
    assert torch.equal(sa.center, s.animate(1.3).center)


def test_animate_time_gradient_matches_jax():
    """d(center)/dt of the beacon orbit through a tensor time against
    jax.jacfwd of the JAX ScaledScene.animate at t = 0.7, within 1e-6."""
    s = make_scaled_scene(n=800, chunk=128, extent=30.0)
    j = jscaled.make_scaled_scene(n=800, chunk=128, extent=30.0)
    t = torch.tensor(0.7, requires_grad=True)
    got = torch.autograd.functional.jacobian(lambda x: s.animate(x).center,
                                             t)
    want = np.asarray(jax.jacfwd(lambda x: j.animate(x).center)(
        jnp.float32(0.7)))
    nl = len(s.emissive_ids)
    assert got.shape == want.shape == tuple(s.center.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.abs(want[:nl]).min(axis=1).max() > 0 and not want[nl:].any()
    assert torch.equal(s.animate(t).center.detach(), s.animate(0.7).center)


def lanes(seed):
    """The ray lanes of tests/test_scaled.py:101 and :169: (2, 32, 128)."""
    rng = np.random.default_rng(seed)
    shape = (2,) + LANE_TILE
    ro = tuple(rng.uniform(-30, 30, shape).astype(np.float32)
               for _ in range(3))
    return rng, shape, ro


@pytest.fixture(scope="module")
def scene3k():
    return (make_scaled_scene(n=3000, chunk=256, extent=40.0),
            jscaled.make_scaled_scene(n=3000, chunk=256, extent=40.0))


@pytest.mark.parametrize("route", ["jnp_scan", "pallas_interpret"])
def test_hit_chunks_matches_jax(scene3k, route):
    s, j = scene3k
    rng, shape, ro = lanes(5)
    d = tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))
    norm = np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
    rd = tuple(x / norm for x in d)
    jro, jrd = tuple(map(jnp.asarray, ro)), tuple(map(jnp.asarray, rd))
    if route == "jnp_scan":
        ref = jscaled.ChunkedScenePort(j).hit_chunks(jro, jrd, 1e-3, 1e7,
                                                     want_material=False)
        want_t, want_id = np.asarray(ref.t), np.asarray(ref.hit_id)
    else:
        port = jscaled.ChunkedScenePort(j, use_pallas=True,
                                        pallas_interpret=True)
        want_t, want_id = map(np.asarray, hit_chunks_tiles(
            port._packed, jro, jrd, chunk=256, t_min=1e-3, t_max=1e7,
            interpret=True))
    t, hid = ChunkedScenePort(s).hit_chunks(
        tuple(map(torch.from_numpy, ro)), tuple(map(torch.from_numpy, rd)),
        1e-3, 1e7)
    assert hid.dtype == torch.int32 and tuple(hid.shape) == shape
    np.testing.assert_array_equal(hid.numpy(), want_id)
    np.testing.assert_allclose(t.numpy(), want_t, rtol=2e-4, atol=0)
    assert (want_id >= 0).sum() > 100


def shadow_rays(s, j):
    rng, shape, ro = lanes(3)
    lights = list(j.emissive_ids)[:4]
    c = s.center.numpy()
    dirs = []
    for e in lights:
        d = tuple(c[e, a] - ro[a] + rng.normal(0, 2, shape).astype(np.float32)
                  for a in range(3))
        norm = np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
        dirs.append(tuple(x / norm for x in d))
    return ro, lights, dirs


@pytest.fixture(scope="module")
def scene800_c64():
    """tests/test_scaled.py:76's scene (800 spheres, chunk 64)."""
    return (make_scaled_scene(n=800, chunk=64, extent=30.0),
            jscaled.make_scaled_scene(n=800, chunk=64, extent=30.0))


@pytest.mark.parametrize("n_lights", [17, 20])
def test_lights_visible_past_sixteen_lights_matches_jax(scene800_c64,
                                                         n_lights):
    """ChunkedScenePort.lights_visible on the CPU past 16 lights (the 8
    beacons and as many other spheres as lights) equal to JAX's jnp scan
    lane for lane; the plain mask takes them 32 at a time, so one call
    here, while a shadow_chunks call on a card takes 16."""
    s, j = scene800_c64
    rng = np.random.default_rng(n_lights)
    n = 512
    ro = tuple(rng.uniform(-25, 25, n).astype(np.float32) for _ in range(3))
    others = [i for i in range(s.n_spheres) if i not in s.emissive_ids]
    lights = list(s.emissive_ids) + others[:n_lights - len(s.emissive_ids)]
    c = s.center.numpy()
    dirs = []
    for e in lights:
        d = tuple(c[e, a] - ro[a] + rng.normal(0, 2, n).astype(np.float32)
                  for a in range(3))
        norm = np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
        dirs.append(tuple(x / norm for x in d))
    want = jscaled.ChunkedScenePort(j).lights_visible(
        tuple(map(jnp.asarray, ro)),
        [tuple(map(jnp.asarray, l)) for l in dirs], lights, 1e-3, 1e7)
    got = ChunkedScenePort(s).lights_visible(
        tuple(map(torch.from_numpy, ro)),
        [tuple(map(torch.from_numpy, l)) for l in dirs], lights, 1e-3, 1e7)
    assert len(got) == len(want) == n_lights
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
    seen = np.stack([g.numpy() for g in got])
    assert seen[16:].any() and not seen[16:].all()
    assert cuda_scaled.mask_lights("cpu") == 32
    assert cuda_scaled.mask_lights("cuda") == cuda_scaled.MAX_LIGHTS == 16


@pytest.mark.parametrize("route", ["jnp_scan", "pallas_interpret"])
def test_shadow_chunks_matches_jax(scene3k, route):
    s, j = scene3k
    ro, lights, dirs = shadow_rays(s, j)
    tro = tuple(map(torch.from_numpy, ro))
    tdirs = [tuple(map(torch.from_numpy, l)) for l in dirs]
    port = ChunkedScenePort(s)
    if route == "jnp_scan":
        want = jscaled.ChunkedScenePort(j).lights_visible(
            tuple(map(jnp.asarray, ro)),
            [tuple(map(jnp.asarray, l)) for l in dirs], lights, 1e-3, 1e7)
        got = port.lights_visible(tro, tdirs, lights, 1e-3, 1e7)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    # the raw bitmask of the fused shadow kernel, on the same t_l planes
    jport = jscaled.ChunkedScenePort(j, use_pallas=True,
                                     pallas_interpret=True)
    jro = tuple(map(jnp.asarray, ro))
    t_ls = [np.array(jscaled.tc._sphere_t(jport.sphere(e), jro,
                                            tuple(map(jnp.asarray, l)), 1e-3,
                                            safe=False)[0])
            for e, l in zip(lights, dirs)]
    flat = tuple(c for l in dirs for c in l)
    want = np.asarray(shadow_chunks_tiles(
        jport._packed, jro, tuple(map(jnp.asarray, flat)),
        tuple(map(jnp.asarray, t_ls)), chunk=256, light_ids=tuple(lights),
        t_min=1e-3, n_l=len(lights), interpret=True))
    got = cuda_scaled.shadow_chunks(
        pack_chunks(s), tro, tuple(map(torch.from_numpy, flat)),
        tuple(map(torch.from_numpy, t_ls)), 256, lights, 1e-3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want != 0).mean() < 1


@pytest.fixture(scope="module")
def scene800():
    return (make_scaled_scene(n=800, chunk=128),
            jscaled.make_scaled_scene(n=800, chunk=128))


@pytest.mark.parametrize("frame", [0, 1])
def test_plain_render_matches_jax(scene800, frame):
    s, j = scene800
    img, rays = render_frame_scaled_plain(s, CFG, frame)
    jimg, jrays = jscaled.render_frame_scaled(j, JCFG, jnp.int32(frame),
                                              pallas=False)
    jimg = np.asarray(jimg)
    assert abs(int(rays) - int(jrays)) <= 1e-3 * int(jrays)
    d = np.abs(img.numpy() - jimg)
    assert (d.max(axis=-1) <= 1e-4).mean() >= 0.985
    assert d.mean() <= 6e-4
    assert np.isfinite(img.numpy()).all() and img.numpy().max() > 0.05


def test_twenty_lights_render_and_differentiate_on_the_cpu():
    """20 emissive ids on the 2048-sphere scene of chunk 64: the plain
    scaled render and its gradient take any count of lights on the CPU
    (the 16-light cap of the per-lane render form and of the per-lane
    chunked K3 binds on a card only), and the render matches JAX's
    render_frame_scaled(pallas=False) at 8x8, spp 1, depth 2 with the
    gates of test_plain_render_matches_jax: rays within 1e-3, mean |diff|
    within 6e-4, and at most 1.5% of the pixels beyond 1e-4, rounded up
    to one of these 64 (measured: rays equal, one pixel at 1.47e-4 of an
    image whose max is 38, mean 2.2e-6: XLA's CPU code fuses a*b - c,
    ROADMAP.md queue 3's measured drift)."""
    import dataclasses
    lights = tuple(range(20))
    s = make_scaled_scene(n=2048, chunk=64).replace(emissive_ids=lights)
    j = dataclasses.replace(jscaled.make_scaled_scene(n=2048, chunk=64),
                            emissive_ids=lights)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1, max_depth=2)
    img, rays = cuda_scaled.render_frame_scaled(s, cfg, 0, device="cpu")
    jimg, jrays = jscaled.render_frame_scaled(
        j, JConfig(width=8, height=8, samples_per_pixel=1, max_depth=2),
        jnp.int32(0), pallas=False)
    jimg = np.asarray(jimg)
    assert abs(int(rays) - int(jrays)) <= 1e-3 * int(jrays)
    d = np.abs(img.numpy() - jimg)
    assert (d.max(axis=-1) > 1e-4).sum() <= np.ceil(0.015 * 64)
    assert d.mean() <= 6e-4
    assert np.isfinite(img.numpy()).all() and img.numpy().max() > 0.05
    albedo = s.albedo.clone().requires_grad_(True)
    img_d, rays_d = cuda_scaled.render_frame_scaled(
        s.replace(albedo=albedo), cfg, 0, device="cpu", differentiable=True)
    assert torch.equal(img_d.detach(), img) and int(rays_d) == int(rays)
    img_d.mean().backward()
    assert torch.isfinite(albedo.grad).all() and albedo.grad.abs().sum() > 0
    g = torch.ones((8, 8, 3))
    _, _, d_tab = cuda_scaled.render_tile_scaled_grad(s, cfg, 0, g, 0, 0, 8,
                                                      8)
    assert d_tab.shape == (14, 2048) and torch.isfinite(d_tab).all()


def test_scaled_autograd_frees_its_tape_and_writes_it_again(monkeypatch):
    """The card's differentiable scaled route (cuda_scaled.
    _ScaledPackedRender) with its two kernels stood in for by the plain
    version, on the CPU: the forward's tape reaches the first backward,
    which frees it; a second backward through the retained graph
    (retain_graph=True, two losses on one render) writes the tape again
    and gets its own cotangent, bit-equal to the plain gradient for its
    weights."""
    import weakref

    from toypathtracer_torch.scaled import (render_tile_scaled_grad_plain,
                                            render_tile_scaled_plain)
    s = make_scaled_scene(n=2048, chunk=64)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1, max_depth=2)
    written, swept = [], []

    def tape(scene, c, frame, x0, y0, h, w, tab=None):
        img, rays = render_tile_scaled_plain(scene, c, frame, x0, y0, h, w,
                                             tab=tab.detach())
        t = {"n": len(written), "rec": torch.zeros(1),
             "tile": (frame, x0, y0, h, w)}
        written.append(weakref.ref(t["rec"]))
        return img, rays, t

    def sweep(scene, c, g_img, t, tab=None):
        swept.append(t["n"])
        frame, x0, y0, h, w = t["tile"]
        return render_tile_scaled_grad_plain(scene, c, frame, g_img, x0, y0,
                                             h, w, tab=tab)[2]

    monkeypatch.setattr(cuda_scaled, "render_tile_scaled_tape", tape)
    monkeypatch.setattr(cuda_scaled, "sweep_scaled_tape", sweep)
    tab = cuda_scaled.pack_scene(s).requires_grad_(True)
    img, _ = cuda_scaled._ScaledPackedRender.apply(tab, s, cfg, 0,
                                                   (0, 0, 8, 8))
    rs = np.random.RandomState(1)
    g1, g2 = (torch.from_numpy(rs.rand(8, 8, 3).astype(np.float32))
              for _ in range(2))
    d1, = torch.autograd.grad((img * g1).sum(), tab, retain_graph=True)
    assert swept == [0] and len(written) == 1 and written[0]() is None
    d2, = torch.autograd.grad((img * g2).sum(), tab)
    assert swept == [0, 1] and len(written) == 2

    def want(g):
        return render_tile_scaled_grad_plain(s, cfg, 0, g, 0, 0, 8, 8,
                                             tab=tab.detach())[2]
    assert torch.equal(d1, want(g1)) and torch.equal(d2, want(g2))
    assert d1.abs().sum() > 0 and not torch.equal(d1, d2)


def test_chunk_culling_is_exact_in_the_port(scene800):
    s_many = scene800[0]
    s_one = make_scaled_scene(n=800, chunk=1024)
    assert s_one.n_chunks == 1 and s_many.n_chunks == 7
    img_m, rays_m = cuda_scaled.render_frame_scaled(s_many, CFG, 1,
                                                    device="cpu")
    img_o, rays_o = cuda_scaled.render_frame_scaled(s_one, CFG, 1,
                                                    device="cpu")
    assert int(rays_m) == int(rays_o)
    assert torch.equal(img_m, img_o)


def test_session_accumulates_and_animates(scene800):
    s = scene800[0]
    small = RenderConfig(width=24, height=12, samples_per_pixel=1,
                         max_depth=3)
    sess = RenderSession(s, small, device="cpu")
    img1 = sess.step(0.0)[0].clone()
    img2 = sess.step(0.0)[0].clone()
    f0, _ = cuda_scaled.render_frame_scaled(s, small, 0, device="cpu")
    f1, _ = cuda_scaled.render_frame_scaled(s, small, 1, device="cpu")
    assert torch.equal(img1, f0)
    assert torch.equal(img2, f0 * 0.5 + f1 * 0.5)
    sess.set_flags(FLAG_PROGRESSIVE | FLAG_ANIMATE)
    anim, _ = sess.step(1.0)
    want, _ = cuda_scaled.render_frame_scaled(s.animate(1.0), small, 0,
                                              device="cpu")
    assert torch.equal(anim, want) and not torch.equal(anim, f0)


def test_cli_renders_the_scaled_scene(tmp_path, capsys):
    out = tmp_path / "scaled.png"
    assert cli_main(["--scaled", "800", "--device", "cpu", "--width", "32",
                     "--height", "16", "--spp", "1", "--max-depth", "3",
                     "--frames", "2", "--output", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "scene=800-sphere" in lines[0]
    assert sum(bool(re.match(r"CPU path tracer .* frames \d+$", ln))
               for ln in lines) == 2
    assert out.exists()


@pytest.mark.parametrize("call", ["differentiable", "silhouette_chunks",
                                  "lights_occlusion_proximity", "sharded"])
def test_out_of_slice_routes_raise(scene800, call):
    """Routes that once raised now compute.  The row-sharded render on a
    2-band CPU mesh is bit-equal to the single-device frame
    (tests/test_torch_sharding.py holds it at 8 bands); the scaled
    gradient's routes: the differentiable frame (its image the forward
    render's) and ChunkedScenePort's soft scans on a plane of lanes
    (tests/test_torch_scaled_grad.py holds their values)."""
    s = scene800[0]
    if call == "sharded":
        from toypathtracer_torch.parallel.mesh import make_mesh
        img, rays = cuda_scaled.render_frame_scaled_sharded(
            s, CFG, 0, mesh=make_mesh([torch.device("cpu")] * 2))
        want, want_rays = cuda_scaled.render_frame_scaled(s, CFG, 0,
                                                          device="cpu")
        assert torch.equal(img, want) and int(rays) == int(want_rays)
        return
    if call == "differentiable":
        center = s.center.clone().requires_grad_(True)
        img, rays = cuda_scaled.render_frame_scaled(
            s.replace(center=center), CFG, 0, device="cpu",
            differentiable=True)
        want, want_rays = cuda_scaled.render_frame_scaled(s, CFG, 0,
                                                          device="cpu")
        assert torch.equal(img.detach(), want) and int(rays) == int(want_rays)
        img.mean().backward()
        assert torch.isfinite(center.grad).all()
        return
    port = ChunkedScenePort(s)
    lanes = (torch.zeros(4), torch.full((4,), 8.0), torch.full((4,), 30.0))
    rd = (torch.linspace(-0.2, 0.2, 4), torch.full((4,), -0.26),
          torch.full((4,), -0.96))
    if call == "silhouette_chunks":
        q = port.silhouette_chunks(lanes, rd, 1e-3,
                                   torch.full((4,), -1, dtype=torch.int32),
                                   0.05)
        assert q.d.shape == (4,) and torch.isfinite(q.d).all()
    else:
        d_occ, = port.lights_occlusion_proximity(lanes, [rd], [0], 1e-3,
                                                 [torch.full((4,), 50.0)])
        assert d_occ.shape == (4,) and torch.isfinite(d_occ).all()


@pytest.mark.parametrize("case", ["rows_shape", "too_many_chunks",
                                  "too_many_lights", "ragged_scene",
                                  "plane_dtype", "hit_form",
                                  "hit_counted_on_cpu"])
def test_wrappers_refuse_unsupported_inputs(scene800, case):
    s = scene800[0]
    rows = pack_chunks(s)
    ro = tuple(torch.zeros(4) for _ in range(3))
    with pytest.raises(ValueError):
        if case == "rows_shape":
            cuda_scaled.hit_chunks(rows, ro, ro, 256, 1e-3, 1e7)
        elif case == "too_many_chunks":
            big = torch.zeros((cuda_scaled.MAX_CHUNKS + 1, 4 * 1 + 8))
            cuda_scaled.hit_chunks(big, ro, ro, 1, 1e-3, 1e7)
        elif case == "too_many_lights":  # the plain mask's 32 bits
            cuda_scaled.shadow_chunks(rows, ro, ro * 33, (ro[0],) * 33, 128,
                                      list(range(33)), 1e-3)
        elif case == "ragged_scene":
            cuda_scaled.render_frame_scaled(
                s.replace(chunk_aabb=s.chunk_aabb[:-1]), CFG, 0,
                device="cpu")
        elif case == "plane_dtype":
            cuda_scaled.hit_chunks(rows, ro, tuple(x.double() for x in ro),
                                   128, 1e-3, 1e7)
        elif case == "hit_form":
            cuda_scaled.hit_chunks_form(rows, ro, ro, 128, 1e-3, 1e7, "lane")
        else:
            cuda_scaled.hit_chunks_form(rows, ro, ro, 128, 1e-3, 1e7,
                                        "thread", stats=True)
