"""The port's fault injection on the events engine without the bank, against
the reference: every role on a known schedule (the fault mask acts on each
delivery batch after drop loss; a crash window is read at the batch's f32
instant), plus a jittered overlay with SELECTIVE draws.

``FaultPair`` (``tests/test_torch_faults.py``) runs each schedule in both
packages with the reference's edge and fault draws fed to the port (a
delivery batch's SELECTIVE draw is indexed by its edge-draw index) and
compares every step: ledgers, counters, the event queue and the draws
consumed, bitwise.
"""
import pytest

from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_faults import CASES, FaultPair, check_role, run_schedule

EVENT_CASES = dict(CASES)
# jittered links: deliveries at each link's own cadence, the mask drawn per batch
EVENT_CASES["selective_jitter"] = (
    ("ring", (6,), dict(link_latency=0.5, latency_jitter=1.0, drop=0.2, seed=2)),
    dict(roles=(3, 0, 3, 0, 0, 0), forward_prob=0.5), None, [(0, 1, 0.2), (3, 2, 0.7)],
    (1, 2.5, 4, 6), None)


@pytest.mark.parametrize("name", sorted(EVENT_CASES))
def test_events_fault_case_matches_reference(name):
    top, faults, part, pubs, times, conv = EVENT_CASES[name]
    pair = FaultPair(top, faults, engine="events", partition=part)
    report = run_schedule(pair, pubs, times, conv)
    assert pair.t.fault_state is None and set(report) == {"roles", "verify_digests"}
    assert pair.t.events_processed > 0
    check_role(name, pair)
    selective = name.startswith("selective")
    assert [c[:2] for c in pair.draws.calls] == (
        [("edges", i) for i in range(pair.t.edge_draws)] if selective else [])


def test_all_honest_events_is_the_unfaulted_run():
    top, faults, part, pubs, times, conv = EVENT_CASES["all_honest"]
    runs = [FaultPair(top, f, engine="events", partition=part, reference=False)
            for f in (None, faults)]
    for pair in runs:
        run_schedule(pair, pubs, times, conv)
    a, b = runs[0].t, runs[1].t
    for x, y in zip(a.replicas.dags + (a._equeue.time, a._equeue.valid),
                    b.replicas.dags + (b._equeue.time, b._equeue.valid)):
        assert x.equal(y)
    assert runs[1].draws.calls == [] and a.events_processed == b.events_processed > 0
