"""Row-sharded rendering over several devices (counterpart of
toypathtracer_tpu/parallel/mesh.py).

The reference fans image rows out over enkiTS worker threads
(Cpp/Source/Test.cpp:356-361) and sums one atomic ray counter
(Test.cpp:299).  Here the image's rows are split statically into bands,
one per entry of a RowMesh: each band renders rows [g*rows, (g+1)*rows) of
the frame, g its global index, on its device with that device's kernels
(the render kernel on a card, the plain version on the CPU), the scene
replicated (it is ~46 x 14 floats), and the ray counts summed, over the
process group with torch.distributed where there is one.

Per-pixel seeds depend only on the global pixel and the frame, so a
sharded frame equals the single-device frame bit for bit.

A RowMesh's devices may repeat: eight bands on one card run one after the
other on it, which is how a single card checks the band split.  The JAX
package's render_frame_sharded_jit (jnp tiles in each shard) and
render_frame_sharded_pallas(interpret=...) (the Pallas kernel in each
shard) have no counterparts of their own: a band's device picks its
renderer, the kernel on a card and the plain version on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch

from ..config import RenderConfig, resolve_device
from ..ops import cuda_render

ROWS_AXIS = "rows"


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """The bands of a row-sharded render.  `devices` are this process's
    bands, one device each (repeats allowed); with a torch.distributed
    `group`, every one of its `world_size` processes holds as many, and
    this process's i-th band is the global band rank * len(devices) + i."""

    devices: Tuple[torch.device, ...]
    axis: str = ROWS_AXIS
    group: Optional[object] = None
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        """Bands over every process (the JAX mesh's axis size)."""
        return self.world_size * len(self.devices)

    def local_rows(self, height: int) -> Tuple[int, int]:
        """(first row, row count) of this process's bands in a frame of
        `height` rows."""
        check_divisible(height, self.size)
        n = height // self.world_size
        return self.rank * n, n

    def bands(self, height: int):
        """(device, y0, rows) of this process's bands, in row order."""
        check_divisible(height, self.size)
        rows = height // self.size
        first = self.rank * len(self.devices)
        return [(dev, (first + i) * rows, rows)
                for i, dev in enumerate(self.devices)]


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, axis: str = ROWS_AXIS, group=None) -> RowMesh:
    """A RowMesh over `devices` (default: every visible card, cuda:0 ...
    cuda:n-1; without a card that raises, as config.resolve_device does:
    the CPU is used only where the caller passes CPU devices).  With a
    torch.distributed `group`, the bands of every process in it make one
    frame."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() found no CUDA device; pass CPU devices, e.g. "
                "make_mesh([torch.device('cpu')] * 8), to render the bands "
                "with the plain PyTorch renderer")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    rank, world = 0, 1
    if group is not None:
        import torch.distributed as dist
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    return RowMesh(devices, axis, group, rank, world)


def check_divisible(height: int, n: int):
    if height % n != 0:
        raise ValueError(
            f"height {height} must divide evenly over {n} devices")


def device_scope(dev: torch.device):
    """Launches inside run on `dev` (its current stream) where it is a
    card."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def replicate(scene, mesh: RowMesh) -> dict:
    """The scene on each distinct device of the mesh, copied once."""
    return {dev: scene.to(dev) for dev in dict.fromkeys(mesh.devices)}


def all_reduce_sum(t: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """Sum of `t` over the mesh's processes (t itself without a group; t
    may be overwritten).  gloo reduces host tensors: a card's tensor goes
    through host memory there, and stays on the card under NCCL."""
    if mesh.group is None:
        return t
    import torch.distributed as dist
    if t.device.type == "cuda" and dist.get_backend(mesh.group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
        return host.to(t.device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def join_bands(bands, mesh: RowMesh):
    """[(band image, band rays)] in row order -> (this process's rows on
    mesh.devices[0], 0-d int64 rays of the whole frame)."""
    dev0 = mesh.devices[0]
    img = torch.cat([b[0].to(dev0) for b in bands], dim=0)
    rays = torch.stack([b[1].to(dev0, torch.int64) for b in bands]).sum()
    return img, all_reduce_sum(rays, mesh)


def render_frame_sharded(scene, cfg: RenderConfig, frame: int,
                         mesh: RowMesh, render_tile=None):
    """Render one frame with its rows split into the mesh's bands.

    `render_tile(scene, cfg, frame, x0, y0, height, width) -> ((height,
    width, 3), rays)` defaults to ops/cuda_render.render_tile: on each
    band's device, the render kernel (its merged form) on a card, the
    plain version on the CPU.  Each band renders at its global y0, so
    per-pixel seeds are those of the whole frame.

    Returns (image, 0-d int64 ray count of the whole frame): with one
    process the full (H, W, 3) frame on mesh.devices[0], bit-equal to
    render_frame; with a group this process's rows
    (distributed.host_local_slice of the frame; distributed.gather_image
    assembles it)."""
    if render_tile is None:
        render_tile = cuda_render.render_tile
    replicas = replicate(scene, mesh)
    out = []
    for dev, y0, rows in mesh.bands(cfg.height):
        with device_scope(dev):
            out.append(render_tile(replicas[dev], cfg, frame, 0, y0, rows,
                                   cfg.width))
    return join_bands(out, mesh)
