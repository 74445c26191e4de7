"""Row-sharded multi-device rendering and training (counterpart of
toypathtracer_tpu/parallel/): `mesh` splits a frame's rows into bands over
devices, `distributed` spans processes with torch.distributed."""

from .mesh import ROWS_AXIS, RowMesh, make_mesh, render_frame_sharded

__all__ = ["ROWS_AXIS", "RowMesh", "make_mesh", "render_frame_sharded"]
