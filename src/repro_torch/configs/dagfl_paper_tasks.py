"""The paper's OWN two FL tasks (Section V.A), as framework configs.

* CNN task  — 2x(5x5 conv + 2x2 maxpool) + FC-512 + softmax on 28x28x1 images
  (McMahan et al. CNN on MNIST), driven with the synthetic MNIST-like dataset.
* LSTM task — 2-layer 256-unit char-level LSTM over 80-char lines, 8-dim
  embedding (McMahan et al. Shakespeare model), driven with the synthetic
  char corpus (``repro_torch.fl.tasks.LSTMTask``).
"""
from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.configs.base import DagFLConfig


@dataclass(frozen=True)
class CNNTaskConfig:
    name: str = "dagfl-cnn"
    image_size: int = 28
    channels: Tuple[int, int] = (32, 64)
    kernel: int = 5
    fc_units: int = 512
    num_classes: int = 10
    learning_rate: float = 0.002
    dagfl: DagFLConfig = field(
        default_factory=lambda: DagFLConfig(
            tx_size_bits=7e6 * 8,          # phi   = 7 MB   (Table I)
            minibatch_size_bits=0.3e6 * 8,  # phi_0 = 0.3 MB
            valset_size_bits=0.3e6 * 8,     # phi_1 = 0.3 MB
            beta=1,
            minibatch=100,
        )
    )
    citation = "DAG-FL paper Table I / McMahan et al. 2017 CNN"


@dataclass(frozen=True)
class LSTMTaskConfig:
    name: str = "dagfl-lstm"
    seq_len: int = 80
    embed_dim: int = 8
    hidden: int = 256
    num_layers: int = 2
    vocab_size: int = 90            # printable chars
    learning_rate: float = 0.3
    dagfl: DagFLConfig = field(
        default_factory=lambda: DagFLConfig(
            tx_size_bits=3e6 * 8,           # phi   = 3 MB (Table I)
            minibatch_size_bits=9e3 * 8,    # phi_0 = 9 KB
            valset_size_bits=9e3 * 8,       # phi_1 = 9 KB
            beta=5,
            minibatch=100,
        )
    )
    citation = "DAG-FL paper Table I / McMahan et al. 2017 stacked char-LSTM"


CNN_TASK = CNNTaskConfig()
LSTM_TASK = LSTMTaskConfig()
