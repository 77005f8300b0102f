"""``repro_torch.dist`` — the distribution substrate of the port (the
slice of ``repro.dist`` that distributed SCE needs): the ``(data,
model)`` mesh over a ``torch.distributed`` process group and the slices
each rank owns (``sharding``), and the collectives with their autograd
rules and payload log (``collectives``)."""
from repro_torch.dist.collectives import (
    distributed_lse_from_local,
    distributed_topk_from_local,
    payload_log,
    payload_summary,
    reset_payload_log,
)
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    Axis,
    Mesh,
    batch_slice,
    catalog_slice,
    data_axes,
    host_batch_slice,
    make_mesh,
)

__all__ = [
    "MODEL_AXIS",
    "Axis",
    "Mesh",
    "batch_slice",
    "catalog_slice",
    "data_axes",
    "distributed_lse_from_local",
    "distributed_topk_from_local",
    "host_batch_slice",
    "make_mesh",
    "payload_log",
    "payload_summary",
    "reset_payload_log",
]
