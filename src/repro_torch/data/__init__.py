"""Data substrate of the port (own copies of the reference's numpy
generators)."""
from repro_torch.data.pipeline import (
    SPLIT_SALTS,
    Cursor,
    ShardedCursor,
    shard_batch,
)
from repro_torch.data.sequences import SeqDataConfig, SequenceDataset

__all__ = ["SPLIT_SALTS", "Cursor", "SeqDataConfig", "SequenceDataset",
           "ShardedCursor", "shard_batch"]
