"""Synthetic data of the port (host numpy)."""
from repro_torch.data.pipeline import MinibatchSampler, TokenSampler, lines_to_batches
from repro_torch.data.synthetic import (
    CharCorpus,
    ImageDataset,
    MnistLike,
    NUM_CLASSES,
    VOCAB,
    add_backdoor_trigger,
    char_partition,
    paper_partition,
)

__all__ = [
    "MinibatchSampler",
    "TokenSampler",
    "lines_to_batches",
    "CharCorpus",
    "ImageDataset",
    "MnistLike",
    "NUM_CLASSES",
    "VOCAB",
    "add_backdoor_trigger",
    "char_partition",
    "paper_partition",
]
