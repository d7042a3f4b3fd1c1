"""A mesh of devices: one process per device, holding whole seeds or a
block of one seed's node rows (``distributed``: the Gloo group; ``mesh``:
a rank's part of the mesh; ``sharding``: which lanes or rows a rank holds
and what crosses ranks on the host; ``exchange``: the row exchange of the
row-sharded layout, on the device; ``launch``: D local ranks in one
command)."""

from zebra_tpu_torch.parallel.distributed import (
    broadcast_one_to_all,
    initialize_distributed,
)
from zebra_tpu_torch.parallel.mesh import Mesh, make_mesh
from zebra_tpu_torch.parallel.sharding import (
    interleave_inverse,
    interleave_permutation,
    local_lanes,
)

__all__ = ["Mesh", "broadcast_one_to_all", "initialize_distributed",
           "interleave_inverse", "interleave_permutation", "local_lanes",
           "make_mesh"]
