"""DAG-FL training over the model zoo (``repro.sharding``): the step of
``fl_step``. The reference's ``specs`` (XLA partition rules) wait for
ROADMAP A.13, part 6."""
from repro_torch.sharding import fl_step
from repro_torch.sharding.fl_step import (
    Frontier,
    Selection,
    aggregate,
    init_frontier,
    make_dagfl_train_step,
    select_peers,
)

__all__ = [
    "fl_step", "Frontier", "Selection", "aggregate", "init_frontier",
    "make_dagfl_train_step", "select_peers",
]
