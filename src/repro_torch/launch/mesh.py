"""Host meshes (port of ``make_host_mesh`` and ``dp_size`` of
``repro/launch/mesh.py``): the mesh is chosen from the ranks of the
``torch.distributed`` world, where the reference counts JAX devices. One
card, or no process group, is a world of one: a (1, 1) mesh."""
from __future__ import annotations

from repro_torch.dist.sharding import Mesh, dp_size, make_mesh, world

__all__ = ["make_host_mesh", "dp_size"]


def make_host_mesh(*, model: int = 1, max_data: int = 0) -> Mesh:
    """A ``(data, model)`` mesh over the world's ranks.

    ``max_data`` > 0 caps the data axis to the largest size that divides
    it (e.g. the global batch), so small batches still shard evenly; the
    surplus ranks are left out of the mesh (``Mesh.member`` is False
    there), as the reference leaves surplus devices out.
    """
    _, n = world()
    model = min(model, n)
    data = n // model
    if max_data > 0:
        while data > 1 and max_data % data != 0:
            data -= 1
    return make_mesh((data, model))

