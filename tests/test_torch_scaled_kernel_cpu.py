"""The scaled kernels' per-ray code (toypathtracer_torch/csrc/chunks.cuh and
render_pixel<ChunkedView> of csrc/trace.cuh), built with g++ for the CPU,
against their plain PyTorch versions (scaled.ChunkTraversal and
scaled.render_tile_scaled_plain).

The traversal is held exactly: the same ids, the same t, the same
occlusion bits, on the rays of tests/test_scaled.py plus rays along the
axes (zero and negative-zero direction components take the +-1e-12
reciprocal) and rays with a NaN component (jnp's NaN-propagating slab test
lets them enter no chunk).  The render is held with
tests/test_torch_kernel_cpu.py's gates (ray count 1e-4 relative, 99.9% of
pixels within 1e-4, mean |diff| 5e-7): glibc's sinf/cosf/expf/logf
against torch's vectorised ones.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from toypathtracer_torch import RenderConfig
from toypathtracer_torch.camera import camera_to_array, make_camera
from toypathtracer_torch.ops import _build, cuda_render
from toypathtracer_torch.scaled import (ChunkTraversal, make_scaled_scene,
                                        pack_chunks,
                                        render_tile_scaled_plain)

torch.set_num_threads(1)

HARNESS = r"""
#include "chunks.cuh"

static tpt::ChunkedView view(const float* rows, const float* box, int C,
                             int K) {
  tpt::ChunkedView V;
  V.tab = nullptr; V.mat = nullptr; V.lights = nullptr;
  V.rows = rows; V.box = box;
  V.n = C * K; V.n_lights = 0; V.chunk = K; V.n_chunks = C;
  return V;
}

extern "C" void tpt_hit_cpu(const float* rows, const float* box, int C,
                            int K, const float* ro, const float* rd, int n,
                            float t_min, float t_max, float* t,
                            int32_t* id) {
  tpt::ChunkedView V = view(rows, box, C, K);
  for (int i = 0; i < n; ++i)
    id[i] = tpt::hit_chunks_ray(V, tpt::v3(ro[i], ro[n + i], ro[2 * n + i]),
                                tpt::v3(rd[i], rd[n + i], rd[2 * n + i]),
                                t_min, t_max, t[i]);
}

extern "C" void tpt_occ_cpu(const float* rows, const float* box, int C,
                            int K, const float* ro, const float* dirs,
                            const float* t_ls, const int32_t* ids, int n_l,
                            int n, float t_min, int32_t* out) {
  tpt::ChunkedView V = view(rows, box, C, K);
  for (int i = 0; i < n; ++i) {
    int32_t bits = 0;
    for (int k = 0; k < n_l; ++k) {
      const float* d = dirs + (size_t)3 * k * n;
      if (tpt::occluded_chunks(
              V, tpt::v3(ro[i], ro[n + i], ro[2 * n + i]),
              tpt::v3(d[i], d[n + i], d[2 * n + i]), ids[k], t_min,
              t_ls[(size_t)k * n + i]))
        bits |= 1 << k;
    }
    out[i] = bits;
  }
}

extern "C" unsigned long long tpt_scaled_render_cpu(
    const float* tab, const float* rows, const float* box,
    const int32_t* mat, const int32_t* lights, const float* cam,
    const tpt::RenderParams* p, int C, int K, float* out) {
  tpt::ChunkedView S = view(rows, box, C, K);
  S.tab = tab; S.mat = mat; S.lights = lights;
  S.n = p->n_spheres; S.n_lights = p->n_lights;
  unsigned long long rays = 0;
  for (int y = 0; y < p->height; ++y)
    for (int x = 0; x < p->width; ++x)
      rays += tpt::render_pixel(S, cam, *p, p->x0 + x, p->y0 + y,
                                out + ((size_t)y * p->width + x) * 3);
  return rays;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("chunks_cpu")
    (d / "host.cpp").write_text(HARNESS)
    so = d / "libchunks_cpu.so"
    # -ffp-contract=off: no FMA contraction, as the CUDA build's -fmad=false
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-ffp-contract=off", f"-I{_build.CSRC}", "-o", str(so),
                    str(d / "host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpt_hit_cpu.argtypes = [ptr, ptr, i32, i32, ptr, ptr, i32, f32, f32,
                                ptr, ptr]
    lib.tpt_occ_cpu.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, i32,
                                i32, f32, ptr]
    lib.tpt_scaled_render_cpu.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ctypes.POINTER(_build.RenderParams),
        i32, i32, ptr]
    lib.tpt_scaled_render_cpu.restype = ctypes.c_ulonglong
    return lib


def c_ptr(a: np.ndarray):
    return a.ctypes.data


def chunk_inputs(scene):
    rows = pack_chunks(scene).numpy()
    K = scene.chunk
    box = np.ascontiguousarray(rows[:, 4 * K:4 * K + 6])
    return rows, box


def scaled_rays(n_lanes=8192):
    """The ray batch of tests/test_scaled.py:101 (n=3000, chunk 256,
    2x32x128 lanes) with a few special rays appended."""
    rng = np.random.default_rng(5)
    ro = rng.uniform(-30, 30, (3, n_lanes)).astype(np.float32)
    d = rng.normal(size=(3, n_lanes)).astype(np.float32)
    rd = d / np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
    axes = np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0],
                     [0, 0, 1], [0, 0, -1], [-0.0, -1, -0.0],
                     [0.6, 0.0, -0.8], [np.nan, 0, 1], [0, -1, 0]],
                    np.float32).T
    ro_axes = np.array([[0, 5, 0], [0, 5, 0], [-30, 0.3, 0], [30, 0.3, 2],
                        [1, 0.3, -30], [1, 0.3, 30], [3, 9, 3],
                        [-10, 0.35, 10], [0, 1, 0], [np.nan, 5, 0]],
                       np.float32).T
    return (np.ascontiguousarray(np.concatenate([ro, ro_axes], 1)),
            np.ascontiguousarray(np.concatenate([rd, axes], 1)))


def test_hit_chunks_ray_matches_plain(host_lib):
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0)
    rows, box = chunk_inputs(scene)
    ro, rd = scaled_rays()
    n = ro.shape[1]
    t = np.zeros(n, np.float32)
    hid = np.zeros(n, np.int32)
    host_lib.tpt_hit_cpu(c_ptr(rows), c_ptr(box), rows.shape[0], 256,
                         c_ptr(ro), c_ptr(rd), n, 1e-3, 1e7, c_ptr(t),
                         c_ptr(hid))
    pt, pid, _, _ = ChunkTraversal(torch.from_numpy(rows), 256).nearest_hit(
        tuple(torch.from_numpy(ro)), tuple(torch.from_numpy(rd)),
        float(np.float32(1e-3)), 1e7)
    np.testing.assert_array_equal(hid, pid.numpy())
    np.testing.assert_array_equal(t, pt.numpy())
    assert (hid >= 0).sum() > 100 and hid[-2] == hid[-1] == -1
    assert (hid[-10:-2] >= 0).sum() >= 4  # the axis rays hit the field


def test_occluded_chunks_matches_plain(host_lib):
    """tests/test_scaled.py:169's shadow rays: toward 4 beacons with
    jittered directions, t_l from the beacon's own root."""
    from toypathtracer_torch.ops import tracecore as tc
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0)
    rows, box = chunk_inputs(scene)
    rng = np.random.default_rng(3)
    n = 8192
    ro = rng.uniform(-30, 30, (3, n)).astype(np.float32)
    c = scene.center.numpy()
    r2 = scene.radius.numpy() ** 2
    lights = [0, 1, 2, 3]
    dirs, t_ls = [], []
    for e in lights:
        d = (c[e][:, None] - ro + rng.normal(0, 2, (3, n))).astype(np.float32)
        d = d / np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
        dirs.append(d)
        t_l, _ = tc.sphere_t(*(float(x) for x in c[e]), float(r2[e]),
                             tuple(torch.from_numpy(ro)),
                             tuple(torch.from_numpy(d)),
                             float(np.float32(1e-3)))
        t_ls.append(t_l.numpy())
    D = np.ascontiguousarray(np.stack(dirs))
    T = np.ascontiguousarray(np.stack(t_ls))
    ids = np.array(lights, np.int32)
    out = np.zeros(n, np.int32)
    host_lib.tpt_occ_cpu(c_ptr(rows), c_ptr(box), rows.shape[0], 256,
                         c_ptr(ro), c_ptr(D), c_ptr(T), c_ptr(ids),
                         len(lights), n, 1e-3, c_ptr(out))
    trav = ChunkTraversal(torch.from_numpy(rows), 256)
    want = np.zeros(n, np.int32)
    for k, e in enumerate(lights):
        occ, slabs, spheres = trav.occluded(
            tuple(torch.from_numpy(ro)), tuple(torch.from_numpy(D[k])), e,
            float(np.float32(1e-3)), torch.from_numpy(T[k]))
        want |= occ.numpy().astype(np.int32) << k
        assert (slabs.numpy() <= rows.shape[0]).all()
        assert (spheres.numpy() <= 256 * slabs.numpy()).all()
    np.testing.assert_array_equal(out, want)
    assert 0 < (out != 0).mean() < 1


def render_host(lib, scene, cfg, frame, x0, y0, h, w):
    """The scaled launcher's inputs, prepared as ops/cuda_scaled does."""
    tab = cuda_render.pack_scene(scene).numpy()
    rows, box = chunk_inputs(scene)
    mat = scene.mat_ids().numpy()
    lights = np.array(scene.emissive_ids, np.int32)
    cam = camera_to_array(make_camera(scene.camera, cfg.width / cfg.height))
    out = np.zeros((h, w, 3), np.float32)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    rays = lib.tpt_scaled_render_cpu(
        c_ptr(tab), c_ptr(rows), c_ptr(box), c_ptr(mat), c_ptr(lights),
        c_ptr(cam), ctypes.byref(params), scene.n_chunks, scene.chunk,
        out.ctypes.data)
    return out, rays


@pytest.mark.parametrize("frame,x0,y0", [(0, 0, 0), (5, 40, 7)])
def test_scaled_render_source_matches_plain(host_lib, frame, x0, y0):
    scene = make_scaled_scene(n=800, chunk=128)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=4)
    h, w = 16, 32
    out, rays = render_host(host_lib, scene, cfg, frame, x0, y0, h, w)
    img, prays = render_tile_scaled_plain(scene, cfg, frame, x0, y0, h, w)
    img = img.numpy()
    assert np.isfinite(out).all() and out.max() > 0.05
    assert abs(rays - int(prays)) <= 1e-4 * int(prays)
    d = np.abs(out - img)
    assert (d.max(axis=-1) <= 1e-4).mean() >= 0.999
    assert d.mean() <= 5e-7
