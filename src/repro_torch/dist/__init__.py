"""``repro_torch.dist`` — the distribution substrate of the port (the
slice of ``repro.dist`` that distributed SCE, the sharded evaluation and
serving need): the ``(data, model)`` mesh over a ``torch.distributed``
process group and the slices each rank owns (``sharding``), and the
collectives with their autograd rules and payload log
(``collectives``)."""
from repro_torch.dist.collectives import (
    all_to_all_bucket_shuffle,
    distributed_lse_from_local,
    distributed_topk,
    distributed_topk_from_local,
    merge_gathered_lse,
    merge_gathered_topk,
    payload_log,
    payload_summary,
    reset_payload_log,
)
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    Axis,
    Mesh,
    batch_rows,
    batch_slice,
    catalog_slice,
    data_axes,
    host_batch_slice,
    local_catalog,
    make_mesh,
    pad_rows,
)

__all__ = [
    "MODEL_AXIS",
    "Axis",
    "Mesh",
    "all_to_all_bucket_shuffle",
    "batch_rows",
    "batch_slice",
    "catalog_slice",
    "data_axes",
    "distributed_lse_from_local",
    "distributed_topk",
    "distributed_topk_from_local",
    "host_batch_slice",
    "local_catalog",
    "make_mesh",
    "merge_gathered_lse",
    "merge_gathered_topk",
    "pad_rows",
    "payload_log",
    "payload_summary",
    "reset_payload_log",
]
