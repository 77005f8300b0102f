"""Data substrate of the port (own copies of the reference's numpy
generators)."""
from repro_torch.data.pipeline import Cursor
from repro_torch.data.sequences import SeqDataConfig, SequenceDataset

__all__ = ["Cursor", "SeqDataConfig", "SequenceDataset"]
