"""Two processes of the port's row-sharded path over torch.distributed
(counterpart of tests/test_distributed.py): toypathtracer_torch.tools.
distributed_smoke on the CPU, gloo, a file:// init method under tmp_path,
2 bands each, so one global 4-band mesh.  The workers import torch alone.

Their frame must be the single-process frame: rays equal to the
single-process 4-band mesh's and the single-device count, each process
holding half the rows, the gathered frame bit-equal; their step's loss
equal on both ranks and rank 0's gradients within rtol 1e-5, atol 1e-8
of the single-process 4-band step (tests/test_distributed.py:100-104):
the two processes sum their bands before the all-reduce, in another order.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.inverse import make_sharded_value_and_grad
from toypathtracer_torch.ops import cuda_render
from toypathtracer_torch.ops.cuda_grad import PARAM_FIELDS
from toypathtracer_torch.parallel import distributed
from toypathtracer_torch.parallel.mesh import (RowMesh, make_mesh,
                                               render_frame_sharded)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = re.compile(r"SMOKE rank=(\d+) bands=(\d+) rays=(\d+) "
                   r"local_rows=(\d+) loss=([-\d.e+]+) step_s=")


def run_workers(tmp_path, world=2, bands=2):
    init = "file://" + str(tmp_path / "init")
    out = str(tmp_path / "grads.npz")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "toypathtracer_torch.tools.distributed_smoke",
         str(rank), str(world), init, str(bands), "cpu", "gloo", out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for rank in range(world)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=120))
    except subprocess.TimeoutExpired:
        pytest.fail("distributed smoke timed out (rendezvous hang?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, f"worker failed:\n{stdout}\n{stderr[-3000:]}"
    return [SMOKE.search(stdout) for stdout, _ in results], np.load(out)


def test_two_process_sharded_render_and_step(tmp_path):
    lines, dist = run_workers(tmp_path)
    assert all(lines), lines
    assert [int(m.group(1)) for m in lines] == [0, 1]
    assert {m.group(2) for m in lines} == {"4"}  # one global 4-band mesh
    assert {m.group(4) for m in lines} == {"16"}  # half the rows each
    rays = {int(m.group(3)) for m in lines}
    assert len(rays) == 1, "processes disagree on the summed ray count"
    losses = {m.group(5) for m in lines}
    assert len(losses) == 1, "processes disagree on the summed loss"

    torch.set_num_threads(1)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=3)
    scene = make_scene(big=True)
    mesh = make_mesh([torch.device("cpu")] * 4)
    img4, rays4 = render_frame_sharded(scene, cfg, 0, mesh)
    img1, rays1 = cuda_render.render_frame(scene, cfg, 0, device="cpu")
    assert rays.pop() == int(rays4) == int(rays1) > 0
    assert torch.equal(img4, img1)
    np.testing.assert_array_equal(dist["frame"], img1.numpy())

    scene_p = scene.replace(center=scene.center + 0.03)
    loss, grads = make_sharded_value_and_grad(cfg, mesh)(
        scene_p, torch.zeros((32, 64, 3)), 1)
    np.testing.assert_allclose(float(losses.pop()), float(loss), rtol=1e-6)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(
            dist[f], grads[f].numpy(), rtol=1e-5, atol=1e-8,
            err_msg=f"{f}: 2-process grads != single-process sharded")


def test_host_local_slice_picks_each_rank_s_rows():
    """The rows a process of a group holds: rank r of 2, 3 bands each."""
    frame = torch.arange(12 * 2 * 3, dtype=torch.float32).reshape(12, 2, 3)
    for rank in range(2):
        mesh = RowMesh((torch.device("cpu"),) * 3, rank=rank, world_size=2)
        assert [b[1:] for b in mesh.bands(12)] == [
            (6 * rank + 2 * i, 2) for i in range(3)]
        assert torch.equal(distributed.host_local_slice(frame, mesh),
                           frame[6 * rank:6 * rank + 6])
    assert distributed.gather_image(frame, make_mesh(["cpu"])) is frame
    distributed.initialize(world_size=1)  # one process: a no-op
