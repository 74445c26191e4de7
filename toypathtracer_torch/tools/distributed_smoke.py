"""Two-process row-sharded smoke worker (counterpart of
tools/distributed_smoke.py): one process of a torch.distributed group
whose processes' bands make one frame.

    python -m toypathtracer_torch.tools.distributed_smoke <rank> <world> \\
        <init_method> <bands_per_process> <device> <backend> [out.npz]

e.g. `... 0 2 file:///tmp/tpt_init 2 cpu gloo` with rank 1 beside it.
Each process renders its bands of the 46-sphere scene at 64 x (8 x global
bands), spp 1, depth 3, frame 0 (the ray count summed over the group),
then takes one sharded value-and-grad step (centres + 0.03, zero target,
frame 1; loss and scene gradient summed over the group), and prints one
line

    SMOKE rank=.. bands=.. rays=.. local_rows=.. loss=.. step_s=..

(step_s: the host clock around a second step, ending in a synchronise,
on a card; 0 on the CPU).  With out.npz rank 0 writes the gradient of
every scene field and the whole frame gathered from every process
("frame").
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (6, 7):
        print(__doc__, file=sys.stderr)
        return 2
    rank, world = int(argv[0]), int(argv[1])
    init_method, bands = argv[2], int(argv[3])
    device, backend = torch.device(argv[4]), argv[5]
    out_path = argv[6] if len(argv) > 6 else ""

    from toypathtracer_torch import RenderConfig, make_scene
    from toypathtracer_torch.inverse import make_sharded_value_and_grad
    from toypathtracer_torch.parallel import distributed
    from toypathtracer_torch.parallel.mesh import render_frame_sharded

    if device.type == "cpu":
        torch.set_num_threads(1)
    distributed.initialize(init_method, world, rank, backend)
    try:
        mesh = distributed.make_global_mesh(devices=[device] * bands)
        if mesh.size != world * bands:
            raise RuntimeError(f"global mesh of {mesh.size} bands, want "
                               f"{world * bands}")
        cfg = RenderConfig(width=64, height=8 * mesh.size,
                           samples_per_pixel=1, max_depth=3)
        scene = make_scene(big=True)
        img, rays = render_frame_sharded(scene, cfg, 0, mesh)
        frame = distributed.gather_image(img, mesh)

        vg = make_sharded_value_and_grad(cfg, mesh)
        target = torch.zeros((cfg.height, cfg.width, 3))
        scene_p = scene.replace(center=scene.center + 0.03)
        loss, grads = vg(scene_p, target, 1)
        step_s = 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            vg(scene_p, target, 1)
            torch.cuda.synchronize(device)
            step_s = time.perf_counter() - t0
        if out_path and rank == 0:
            np.savez(out_path, frame=frame.cpu().numpy(),
                     **{f: g.cpu().numpy() for f, g in grads.items()})
        print(f"SMOKE rank={rank} bands={mesh.size} rays={int(rays)} "
              f"local_rows={img.shape[0]} loss={float(loss):.9e} "
              f"step_s={step_s:.6f}", flush=True)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
