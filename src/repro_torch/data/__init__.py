"""Data substrate of the port (own copies of the reference's numpy
generators)."""
from repro_torch.data.clickstream import ClickDataConfig, ClickstreamDataset
from repro_torch.data.graphs import (
    GraphDataConfig,
    NeighborSampler,
    batched_molecules,
    random_graph,
)
from repro_torch.data.pipeline import (
    SPLIT_SALTS,
    Cursor,
    ShardedCursor,
    shard_batch,
)
from repro_torch.data.sequences import SeqDataConfig, SequenceDataset, lm_batch

__all__ = ["SPLIT_SALTS", "ClickDataConfig", "ClickstreamDataset", "Cursor",
           "GraphDataConfig", "NeighborSampler", "SeqDataConfig",
           "SequenceDataset", "ShardedCursor", "batched_molecules",
           "lm_batch", "random_graph", "shard_batch"]
