"""Multi-process row sharding (counterpart of
toypathtracer_tpu/parallel/distributed.py).

Every process calls `initialize()` and builds one global mesh with
`make_global_mesh()`: each holds its own bands of the frame, and the
reductions (the ray count, the training step's loss and scene gradient)
are torch.distributed all-reduces over the default process group, NCCL
between cards and gloo on the CPU.  A process's render is its own rows;
`host_local_slice` picks them out of a whole frame and `gather_image`
assembles the whole frame on every process (the JAX package's
process_allgather).

Nothing here discovers a cluster: the caller gives the init method (e.g.
"tcp://localhost:<port>" or "file:///path"), the world size and the rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import ROWS_AXIS, RowMesh, make_mesh


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """torch.distributed.init_process_group (a no-op for one process).
    `backend` defaults to "nccl" where a card is present and "gloo"
    elsewhere; "gloo" on a card is allowed (several processes sharing one
    card, which NCCL refuses)."""
    if world_size is not None and world_size <= 1:
        return
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)


def make_global_mesh(axis: str = ROWS_AXIS, devices=None) -> RowMesh:
    """The mesh of this process's bands over the default process group
    (call after initialize()).  `devices` defaults to one band on card
    rank % device_count; without a card, and without `devices`, it
    raises, as make_mesh does."""
    import torch.distributed as dist
    group = dist.group.WORLD if dist.is_initialized() else None
    if devices is None and torch.cuda.is_available():
        rank = dist.get_rank() if group is not None else 0
        devices = [torch.device("cuda", rank % torch.cuda.device_count())]
    return make_mesh(devices, axis, group)


def host_local_slice(frame: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The rows of a whole (H, W, 3) frame that this process's bands
    render, in row order: what render_frame_sharded returns on it."""
    y0, n = mesh.local_rows(frame.shape[0])
    return frame[y0:y0 + n]


def gather_image(image: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The whole frame on every process from each one's rows
    (render_frame_sharded's image), in rank order.  Under NCCL the gather
    runs on the card; gloo gathers host tensors only, so a card's rows go
    through host memory there."""
    if mesh.group is None:
        return image
    import torch.distributed as dist
    image = image.contiguous()
    if image.device.type == "cuda" and dist.get_backend(mesh.group) != "gloo":
        out = torch.empty((mesh.world_size, *image.shape), dtype=image.dtype,
                          device=image.device)
        dist.all_gather_into_tensor(out, image, group=mesh.group)
        return out.reshape(-1, *image.shape[1:])
    host = image.cpu()
    parts = [torch.empty_like(host) for _ in range(mesh.world_size)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.cat(parts, dim=0).to(image.device)
