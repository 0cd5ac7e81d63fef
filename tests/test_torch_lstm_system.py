"""``run_dagfl`` on the bench LSTM against the reference's run.

The reference's initial parameters and its threefry tip-selection draws go
into the port (``params_from_jax`` and the ``draw`` hook); host numpy
randomness is the same by construction. Latency, curve, the ledger's
integer columns, its publish times and accuracies must be equal, and the
final parameters within 1e-4. A lazy population, so both prepare paths run.
"""
import numpy as np

from repro.fl import experiments as j_exp
from repro.fl import systems as j_sys
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys

from test_torch_baselines import assert_same_result, seeded_task
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_system import INT_FIELDS, _reference_draws


def test_run_dagfl_on_the_lstm_matches_reference():
    n, seed = 8, 0
    sim_kw = dict(iterations=12, eval_every=4, steps_per_iter=2, seed=seed)
    jt, jn, jg, _ = j_exp.make_lstm_setup(num_nodes=n, abnormal="lazy", num_abnormal=2, seed=seed)
    _, tn, tg, _ = t_exp.make_lstm_setup(num_nodes=n, abnormal="lazy", num_abnormal=2, seed=seed)
    jd, td = j_exp.default_dagfl_config(n, "lstm"), t_exp.default_dagfl_config(n, "lstm")
    assert td.beta == 5
    rj = j_sys.run_dagfl(jt, jn, jd, j_sys.SimConfig(**sim_kw), jg)
    rt = t_sys.run_dagfl(seeded_task(jt, seed), tn, td, t_sys.SimConfig(**sim_kw), tg,
                         device="cpu", draw=_reference_draws(seed, td.capacity))
    assert_same_result(rt, rj)
    dj, dt = rj.extras["dag"], rt.extras["dag"]
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(dt, f).numpy(), np.asarray(getattr(dj, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(dt.publish_time.numpy(), np.asarray(dj.publish_time))
    np.testing.assert_array_equal(dt.accuracy.numpy(), np.asarray(dj.accuracy))
    assert rt.extras["behaviors"] == rj.extras["behaviors"]
    assert int(dt.count) == 13
