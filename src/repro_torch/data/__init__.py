"""Data substrate of the port (own copies of the reference's numpy
generators)."""
from repro_torch.data.pipeline import (
    SPLIT_SALTS,
    Cursor,
    ShardedCursor,
    shard_batch,
)
from repro_torch.data.sequences import SeqDataConfig, SequenceDataset, lm_batch

__all__ = ["SPLIT_SALTS", "Cursor", "SeqDataConfig", "SequenceDataset",
           "ShardedCursor", "lm_batch", "shard_batch"]
