"""Table II's numbers on the LSTM task (``iteration_delay_experiment``), the
port's against the reference's, at one iteration: the 100-node char
population takes about 11 s to build on each side.
"""
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_experiments import assert_same_table2


def test_iteration_delay_experiment_on_the_lstm():
    assert_same_table2("lstm")
