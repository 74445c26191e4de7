"""The port's plain trace core (toypathtracer_torch/ops/tracecore.py)
against the JAX package's (toypathtracer_tpu/ops/tracecore.py) on the CPU.

Inputs come from np.random.default_rng and go to both packages.
Tolerances:
  * RNG, seeding and draw counts: bit-exact (integer logic);
  * float results: rtol 1e-5 / atol 1e-6.  torch and XLA disagree in the
    last bits of float32 sin/cos (1 ulp on ~5% of inputs), sqrt (1 ulp on
    0.6%) and the exp(log(x)/3) cube root (up to 8 ulp); everything
    downstream of those inherits a few ulp, except results behind a
    cancellation, which get the lane-fraction gate of close_most;
  * booleans of the shadow test: equal wherever the compared quantities
    keep a 1e-5 margin from their thresholds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import make_scene as j_make_scene
from toypathtracer_tpu.camera import make_camera as j_make_camera
from toypathtracer_tpu.ops import tracecore as jtc
from toypathtracer_tpu.render.wavefront import ArrayScenePort
from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.ops import cuda_render
from toypathtracer_torch.ops import tracecore as tc
from toypathtracer_torch.render.wavefront import camera_scalars

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
SEEDS = [0, 1, 2]


def states(rng, n=4096):
    return rng.integers(1, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def t64(a):
    """uint32 numpy -> the port's int64 RNG state tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def tf(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               rtol=RTOL, atol=ATOL)


def close3(t3, j3, close=close):
    for a, b in zip(t3, j3):
        close(a, b)


def close_most(t, j):
    """For results downstream of a cancellation -- a sphere root
    nb - sqrt(d), a cone sample sqrt(1 - cos_a^2), the Lambert direction
    normalize(normal + ruv) when ruv ~ -normal -- a 1-ulp sqrt or sin/cos
    difference is amplified.  At least 97% of lanes hold rtol 1e-5 /
    atol 1e-6 (measured: 98.4% at worst), every lane atol 1e-3 (measured
    max 1.2e-4)."""
    t, j = np.asarray(t), np.asarray(j)
    assert np.isclose(t, j, rtol=RTOL, atol=ATOL).mean() >= 0.97
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-3)


def unit_dirs(rng, n):
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    return d


@pytest.mark.parametrize("seed", SEEDS)
def test_xorshift_rand01_bitexact(seed):
    s = states(np.random.default_rng(seed))
    np.testing.assert_array_equal(
        tc.xorshift32(t64(s)).numpy(),
        np.asarray(jtc.xorshift32(jnp.asarray(s))).astype(np.int64))
    ts, tv = tc.rand01(t64(s))
    js, jv = jtc.rand01(jnp.asarray(s))
    np.testing.assert_array_equal(ts.numpy(),
                                  np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("frame", [0, 3, 2**31 + 12345])
def test_seed_pixels_bitexact(frame):
    rng = np.random.default_rng(frame % 1000)
    x = rng.integers(0, 4096, size=(64, 64)).astype(np.int32)
    y = rng.integers(0, 4096, size=(64, 64)).astype(np.int32)
    j = np.asarray(jtc.seed_pixels(jnp.asarray(x), jnp.asarray(y), frame))
    t = tc.seed_pixels(torch.from_numpy(x), torch.from_numpy(y), frame)
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))


@pytest.mark.parametrize("name", ["random_in_unit_disk",
                                  "random_in_unit_sphere",
                                  "random_unit_vector"])
def test_gpu_samplers(name):
    s = states(np.random.default_rng(7))
    ts, tv = getattr(tc, name)(t64(s))
    js, jv = jax.jit(getattr(jtc, name))(jnp.asarray(s))
    # draw count and RNG state: exact
    np.testing.assert_array_equal(ts.numpy(),
                                  np.asarray(js).astype(np.int64))
    close3(tv, jv)


@pytest.mark.parametrize("big", [True, False])
def test_camera_get_ray(big):
    rng = np.random.default_rng(11)
    cfg = RenderConfig(width=128, height=16)
    scene = make_scene(big=big)
    jscene = j_make_scene(big=big)
    s = rng.random(2048, dtype=np.float32)
    t = rng.random(2048, dtype=np.float32)
    st = states(rng, 2048)
    ts, tro, trd = tc.camera_get_ray(camera_scalars(scene, cfg), tf(s), tf(t),
                                     t64(st))
    jcam = j_make_camera(jscene.camera, cfg.width / cfg.height)
    js, jro, jrd = jax.jit(lambda a, b, c: jtc.camera_get_ray(jcam, a, b, c))(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(st))
    np.testing.assert_array_equal(ts.numpy(),
                                  np.asarray(js).astype(np.int64))
    close3(tro, jro)
    close3(trd, jrd)


def test_sphere_t():
    rng = np.random.default_rng(5)
    n = 4096
    ro = rng.uniform(-3, 3, size=(3, n)).astype(np.float32)
    rd = unit_dirs(rng, n)
    c = rng.uniform(-3, 3, size=(3, n)).astype(np.float32)
    r = rng.uniform(0.2, 1.5, size=n).astype(np.float32)
    sp = jtc.SphereData(*(jnp.asarray(v) for v in (c[0], c[1], c[2], r * r,
                                                   1 / r, r)))
    jt, jv = jtc._sphere_t(sp, tuple(map(jnp.asarray, ro)),
                           tuple(map(jnp.asarray, rd)), 0.001, safe=False)
    tt, tv = tc.sphere_t(tf(c[0]), tf(c[1]), tf(c[2]), tf(r * r),
                         tuple(map(tf, ro)), tuple(map(tf, rd)),
                         float(np.float32(0.001)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    close(tt.numpy()[tv.numpy()], np.asarray(jt)[tv.numpy()])


@pytest.mark.parametrize("seed", SEEDS)
def test_occ_test_booleans(seed):
    rng = np.random.default_rng(seed)
    n = 20000
    nb = rng.uniform(-4, 4, n).astype(np.float32)
    c = rng.uniform(-4, 16, n).astype(np.float32)
    t_l = rng.uniform(0.01, 6, n).astype(np.float32)
    t_min = np.float32(0.001)
    j = np.asarray(jtc._occ_test(jnp.asarray(nb), jnp.asarray(c), t_min,
                                 jnp.asarray(t_l)))
    t = tc.occ_test(tf(nb), tf(c), float(t_min), tf(t_l)).numpy()
    d = nb * nb - c
    a = nb - t_min
    b = nb - t_l
    margin = ((np.abs(d) > 1e-5) & (np.abs(d - b * np.abs(b)) > 1e-5)
              & (np.abs(d + a * np.abs(a)) > 1e-5))
    assert margin.mean() > 0.99
    np.testing.assert_array_equal(t[margin], j[margin])
    assert 0.05 < t.mean() < 0.95  # both outcomes are exercised


def camera_rays(scene, cfg, rng, n=2048):
    """Primary rays through random screen points (the ray inputs of the
    geometry tests)."""
    st = states(rng, n)
    u = rng.random(n, dtype=np.float32)
    v = rng.random(n, dtype=np.float32)
    _, ro, rd = tc.camera_get_ray(camera_scalars(scene, cfg), tf(u), tf(v),
                                  t64(st))
    return tuple(x.numpy() for x in ro), tuple(x.numpy() for x in rd)


@pytest.mark.parametrize("big", [True, False])
def test_nearest_hit_and_gather(big):
    rng = np.random.default_rng(3)
    cfg = RenderConfig(width=128, height=16)
    scene, jscene = make_scene(big=big), j_make_scene(big=big)
    ro, rd = camera_rays(scene, cfg, rng)
    tab = cuda_render.pack_scene(scene)
    mat = torch.tensor(scene.mat_type)
    t, hid = tc.nearest_hit(tab, tuple(map(tf, ro)), tuple(map(tf, rd)),
                            float(np.float32(cfg.min_t)),
                            float(np.float32(cfg.max_t)))
    w = tc.gather_winner(tab, mat, hid)
    port = ArrayScenePort(jscene)
    res = jax.jit(lambda a, b: jtc.hit_spheres(port, a, b, cfg.min_t,
                                               cfg.max_t))(
        tuple(map(jnp.asarray, ro)), tuple(map(jnp.asarray, rd)))
    np.testing.assert_array_equal(hid.numpy(), np.asarray(res.hit_id))
    assert (hid.numpy() >= 0).mean() > 0.3  # both hits and misses
    close(t, res.t)
    close3(w.center, (res.cx, res.cy, res.cz))
    close(w.inv_radius, res.inv_radius)
    close3(w.alb, res.alb)
    close3(w.em, res.em)
    close(w.roughness, res.roughness)
    close(w.ri, res.ri)
    np.testing.assert_array_equal((w.mat == 0).numpy(),
                                  np.asarray(res.is_lambert))
    np.testing.assert_array_equal((w.mat == 2).numpy(),
                                  np.asarray(res.is_dielectric))


@pytest.mark.parametrize("mitsuba", [False, True])
def test_sky_color(mitsuba):
    rd = unit_dirs(np.random.default_rng(9), 1024)
    cfg = RenderConfig(do_mitsuba_compare=mitsuba)
    jcfg = JConfig(do_mitsuba_compare=mitsuba)
    close3(tc.sky_color(tuple(map(tf, rd)), cfg),
           jtc.sky_color(tuple(map(jnp.asarray, rd)), jcfg))


def nee_inputs(rng, n=2048):
    pos = np.stack([rng.uniform(-4, 4, n), rng.uniform(-0.4, 2.0, n),
                    rng.uniform(-6, 2, n)]).astype(np.float32)
    hit_id = rng.integers(-1, 46, n).astype(np.int32)
    active = rng.random(n) < 0.7
    normal = unit_dirs(rng, n)
    rd = unit_dirs(rng, n)
    alb = rng.random((3, n), dtype=np.float32)
    return pos, hit_id, active, normal, rd, alb, states(rng, n)


@pytest.mark.parametrize("seed", SEEDS)
def test_nee_cones_and_light_e(seed):
    rng = np.random.default_rng(seed)
    pos, hit_id, active, normal, rd, alb, st = nee_inputs(rng)
    scene, jscene = make_scene(big=True), j_make_scene(big=True)
    cfg, jcfg = RenderConfig(), JConfig()
    tab = cuda_render.pack_scene(scene)
    ts, cones = tc.nee_cones(tab, scene.emissive_ids, tuple(map(tf, pos)),
                             torch.from_numpy(hit_id),
                             torch.from_numpy(active), t64(st))
    light_e, cnt, _ = tc.nee_light_e(tab, cfg, cones, tuple(map(tf, pos)),
                                  tuple(map(tf, alb)), tuple(map(tf, normal)),
                                  tuple(map(tf, rd)))
    port = ArrayScenePort(jscene)

    def jax_nee(pos, hit_id, active, st, alb, normal, rd):
        st, jcones = jtc._nee_cones(port, jcfg, pos, hit_id, active, st,
                                    jtc.GPU_SAMPLERS)
        sees = jtc.lights_visible_fused(port, pos, [c[3] for c in jcones],
                                        [c[0] for c in jcones], jcfg.min_t,
                                        jcfg.max_t)
        le, sc = jtc._nee_light_e(jcfg, jcones, sees, [None] * len(jcones),
                                  alb, normal, rd, False)
        return st, [(c[2], c[3], c[4]) for c in jcones], sees, le, sc

    v3 = lambda a: tuple(map(jnp.asarray, a))  # noqa: E731
    js, jcones, sees, jle, jcnt = jax.jit(jax_nee)(
        v3(pos), jnp.asarray(hit_id), jnp.asarray(active), jnp.asarray(st),
        v3(alb), v3(normal), v3(rd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for (e, on, l, cam), (jon, jl, jcam) in zip(cones, jcones):
        np.testing.assert_array_equal(on.numpy(), np.asarray(jon))
        close3(l, jl, close_most)
        close(cam, jcam)
    assert np.mean([np.asarray(s).mean() for s in sees]) > 0.05
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    close3(light_e, jle, close_most)


@pytest.mark.parametrize("seed", SEEDS)
def test_scatter_metal_and_dielectric(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    st = states(rng, n)
    rd = unit_dirs(rng, n)
    normal = unit_dirs(rng, n)
    refl = unit_dirs(rng, n)
    rough = rng.choice([0.0, 0.2, 0.6], n).astype(np.float32)
    ri = rng.choice([0.0, 1.5], n).astype(np.float32)
    v3t = lambda a: tuple(map(tf, a))  # noqa: E731
    v3j = lambda a: tuple(map(jnp.asarray, a))  # noqa: E731
    ts, td = tc.scatter_metal(t64(st), v3t(refl), tf(rough))
    js, jd = jax.jit(lambda s, r, g: jtc._scatter_metal(
        s, r, g, jtc.GPU_SAMPLERS))(jnp.asarray(st), v3j(refl),
                                    jnp.asarray(rough))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    close3(td, jd)
    ts, td = tc.scatter_dielectric(t64(st), v3t(rd), v3t(normal), v3t(refl),
                                   tf(ri))
    js, jd = jax.jit(jtc._scatter_dielectric)(
        jnp.asarray(st), v3j(rd), v3j(normal), v3j(refl), jnp.asarray(ri))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    close3(td, jd)


@pytest.mark.parametrize("light_sampling", [True, False])
def test_one_bounce(light_sampling):
    """One bounce over camera rays (bounce_parts): the same lanes hit,
    scatter, draw and count; positions, directions, e and c agree to the
    float tolerance of results downstream of a sphere root."""
    rng = np.random.default_rng(13)
    n = 2048
    cfg = RenderConfig(width=128, height=16,
                       do_light_sampling=light_sampling)
    jcfg = JConfig(width=128, height=16, do_light_sampling=light_sampling)
    scene, jscene = make_scene(big=True), j_make_scene(big=True)
    ro, rd = camera_rays(scene, cfg, rng, n)
    st = states(rng, n)
    alive = rng.random(n) < 0.9
    do_me = rng.random(n) < 0.5
    tab = cuda_render.pack_scene(scene)
    mat = torch.tensor(scene.mat_type)
    zero = torch.zeros(n, dtype=torch.int64)
    (t_ro, t_rd, t_alive, t_dome, t_st, work), te, tcc = tc.bounce(
        tab, mat, scene.emissive_ids, cfg,
        (tuple(map(tf, ro)), tuple(map(tf, rd)), torch.from_numpy(alive),
         torch.from_numpy(do_me), t64(st), tc.Work(zero, zero, zero)))
    port = ArrayScenePort(jscene)
    carry = (tuple(map(jnp.asarray, ro)), tuple(map(jnp.asarray, rd)),
             jnp.asarray(alive), jnp.asarray(do_me), jnp.asarray(st),
             jnp.zeros(n, jnp.int32))
    (j_ro, j_rd, j_alive, j_dome, j_st, j_cnt), je, jc = jax.jit(
        lambda c: jtc.bounce_parts(port, jcfg, c))(carry)
    np.testing.assert_array_equal(t_alive.numpy(), np.asarray(j_alive))
    np.testing.assert_array_equal(t_dome.numpy(), np.asarray(j_dome))
    np.testing.assert_array_equal(t_st.numpy(),
                                  np.asarray(j_st).astype(np.int64))
    np.testing.assert_array_equal((work.traced + work.shadow).numpy(),
                                  np.asarray(j_cnt))
    assert 0.2 < t_alive.numpy().mean() < 0.95
    for t3, j3 in ((t_ro, j_ro), (t_rd, j_rd), (te, je), (tcc, jc)):
        close3(t3, j3, close_most)


def test_occlusion_work_count_is_the_loops():
    """occluded()'s test count is what a per-ray loop in sphere order that
    skips the light and stops at the first occluder does (the kernel's
    loop, csrc/trace.cuh), counted here by brute force."""
    rng = np.random.default_rng(17)
    n = 512
    scene = make_scene(big=True)
    tab = cuda_render.pack_scene(scene)
    pos = np.stack([rng.uniform(-4, 4, n), rng.uniform(-0.4, 2.0, n),
                    rng.uniform(-6, 2, n)]).astype(np.float32)
    l = unit_dirs(rng, n)
    t_l = rng.uniform(0.5, 8, n).astype(np.float32)
    light = 8
    occ, tests = tc.occluded(tab, tuple(map(tf, pos)), tuple(map(tf, l)),
                             light, 0.001, tf(t_l))
    tabn = tab.numpy()
    for k in range(n):
        count, hit = 0, False
        for i in range(tabn.shape[1]):
            if i == light:
                continue
            count += 1
            co = tabn[:3, i] - pos[:, k]
            c = np.float32(co @ co - tabn[3, i])
            nb = np.float32(co @ l[:, k])
            if bool(tc.occ_test(tf([nb]), tf([c]), 0.001, tf([t_l[k]]))[0]):
                hit = True
                break
        assert (bool(occ[k]), int(tests[k])) == (hit, count)
    assert 0.05 < occ.double().mean() < 0.95
