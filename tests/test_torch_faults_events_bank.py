"""The port's fault injection on the banked events engine against the
reference: every role with the bank gossiped and starved links (chunks
drain between deliveries), SPOOF with and without digest verification, and
SPOOF through the int4 codec's price.

On the events engine every batch, a drain-only one too, draws its spoofed
transfers from ``fold_in(fold_in(key, 11), done)``: ``key`` is the key
after the batch's split (a drain-only batch splits nothing) and ``done`` the
batch's count within its advance; ``reference_fault_draw`` feeds those
draws to the port's "spoof_batch" stream at index ``(edge_draws, done)``.
``FaultPair`` (``tests/test_torch_faults.py``) compares every step bitwise:
ledgers, the queue, ``have``, ``credit``, ``sent``, ``last_srv``,
``rejects``, ``tainted``, the fault report and the rejection credit.
"""
import pytest

from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_faults import CASES, FaultPair, check_role, run_schedule
from test_torch_faults_bank import check_spoof

BANK = dict(chunks_per_slot=4)
STARVED = dict(bandwidth=48.0)     # 6 B/s against 8 B chunks: drains arm between deliveries

EVENT_BANK_CASES = {name: CASES[name] for name in (
    "selective_p0", "selective_p1", "crash_window", "crash_through_partition",
    "eclipse_star_hub", "sybil")}
EVENT_BANK_CASES["all_honest"] = (
    ("ring", (6,), dict(link_latency=1.0, drop=0.3, seed=3, **STARVED)),
    *CASES["all_honest"][1:])
EVENT_BANK_CASES["selective_half"] = (
    ("full", (6,), dict(link_latency=0.5, latency_jitter=1.0, drop=0.2, seed=1, **STARVED)),
    *CASES["selective_half"][1:])
SPOOF_CASES = {
    "spoof_refetch": (("ring", (6,), dict(link_latency=1.0)),
                      dict(roles=(0, 4, 0, 0, 0, 0), spoof_rate=1.0, quarantine_after=2),
                      None, [(0, 1, 0.2)], range(1, 16), 30.0, None),
    "spoof_half_rate": (("full", (5,), dict(link_latency=1.0, **STARVED)),
                        dict(roles=(4, 0, 0, 0, 0), spoof_rate=0.5, quarantine_after=3),
                        None, [(0, 1, 0.2), (2, 2, 0.4)], range(1, 9), None, None),
    "spoof_unverified": (("full", (5,), dict(link_latency=1.0, **STARVED)),
                         dict(roles=(4, 0, 0, 0, 0), spoof_rate=1.0, verify_digests=False),
                         None, [(0, 1, 0.2)], range(1, 8), None, None),
    "spoof_int4": (("full", (5,), dict(link_latency=0.5, latency_jitter=1.0, seed=4,
                                       bandwidth=16.0)),
                   dict(roles=(0, 0, 0, 0, 4), spoof_rate=0.7, quarantine_after=2),
                   None, [(4, 1, 0.2), (1, 2, 0.3)], range(1, 9), None, "int4"),
}


@pytest.mark.parametrize("name", sorted(EVENT_BANK_CASES) + sorted(SPOOF_CASES))
def test_banked_events_fault_case_matches_reference(name):
    if name in SPOOF_CASES:
        top, faults, part, pubs, times, conv, codec = SPOOF_CASES[name]
    else:
        (top, faults, part, pubs, times, conv), codec = EVENT_BANK_CASES[name], None
    pair = FaultPair(top, faults, engine="events", bank=BANK, codec=codec, partition=part)
    report = run_schedule(pair, pubs, times, conv)
    if name not in SPOOF_CASES:
        check_role(name, pair)
        assert report["rejected_total"] == 0
        return
    check_spoof(name, pair, report)
    calls = pair.draws.calls
    # every batch of the advances draws, converge's ticks at their round index
    batch = [c for c in calls if c[0] == "spoof_batch"]
    assert len(batch) == pair.t.events_processed
    if name == "spoof_half_rate":
        splits = [index[0] for _s, index, _shape in batch]
        assert len(set(splits)) < len(splits)      # drain-only batches reuse the key
