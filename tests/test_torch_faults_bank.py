"""The port's fault injection on the banked ticks engine against the
reference: every role with the bank gossiped, SPOOF with digest
verification (rejections, quarantine, the re-fetch from an alternate
holder, no tainted chunk in any gated view) and without it (the infection
spreads), and SPOOF through the int8 codec's price.

``FaultPair`` (``tests/test_torch_faults.py``) runs each schedule in both
packages with the reference's edge and fault draws fed to the port and
compares every step. Tolerances: bitwise — ledgers, ``have``, ``credit``,
``sent``, ``rejects``, ``tainted``, the fault report and the rejection
credit.
"""
import numpy as np
import pytest
import torch

from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_faults import CASES, FaultPair, check_role, run_schedule

BANK = dict(chunks_per_slot=4)

# the bankless file's roles with the bank gossiped, starved where marked
BANK_CASES = dict(CASES)
BANK_CASES["all_honest"] = (
    ("ring", (6,), dict(link_latency=1.0, drop=0.3, seed=3, bandwidth=48.0)),
    *CASES["all_honest"][1:])
BANK_CASES["selective_half"] = (
    ("full", (6,), dict(link_latency=1.0, drop=0.2, bandwidth=64.0)),
    *CASES["selective_half"][1:])
SPOOF_CASES = {
    # the spoofer, next to the honest publisher on a ring, relays the payload
    # to node 2: node 2 rejects it, quarantines the link and fetches the
    # payload the other way round
    "spoof_refetch": (("ring", (6,), dict(link_latency=1.0)),
                      dict(roles=(0, 4, 0, 0, 0, 0), spoof_rate=1.0, quarantine_after=2),
                      None, [(0, 1, 0.2)], range(1, 16), 30.0, None),
    "spoof_half_rate": (("full", (5,), dict(link_latency=1.0, bandwidth=64.0)),
                        dict(roles=(4, 0, 0, 0, 0), spoof_rate=0.5, quarantine_after=3),
                        None, [(0, 1, 0.2), (2, 2, 0.4)], range(1, 9), None, None),
    "spoof_unverified": (("full", (5,), dict(link_latency=1.0)),
                         dict(roles=(4, 0, 0, 0, 0), spoof_rate=1.0, verify_digests=False),
                         None, [(0, 1, 0.2)], range(1, 8), None, None),
    "spoof_int8": (("full", (5,), dict(link_latency=1.0, bandwidth=64.0)),
                   dict(roles=(0, 0, 0, 0, 4), spoof_rate=0.7, quarantine_after=2),
                   None, [(4, 1, 0.2), (1, 2, 0.3)], range(1, 9), 30.0, "int8"),
}


def check_spoof(name, pair, report):
    """The defense's claims, as the reference's tests state them."""
    t = pair.t
    spoofers = np.flatnonzero(report["roles"] == 4)
    honest = np.flatnonzero(report["roles"] != 4)
    if not t.faults_cfg.verify_digests:
        assert report["tainted_in_views"].sum() > 0 and report["rejected_total"] == 0
        assert report["tainted_chunks"].sum() > 0
        return
    assert (report["tainted_in_views"] == 0).all() and not t.fault_state.tainted.any()
    assert report["rejected_total"] > 0
    rejects = report["rejects"]
    assert rejects[:, honest].sum() == 0                   # only spoofers are charged
    quarantined = t.quarantined_links()
    assert not quarantined[:, honest].any()                # every cut link's sender spoofs
    if name != "spoof_half_rate":
        assert quarantined[:, spoofers].any()
    credit = report["rejection_credit"]
    assert (credit[spoofers] < 1.0).all() and (credit[honest] == 1.0).all()
    if name == "spoof_refetch":
        assert int(t.missing_chunks().max()) == 0 and t.synced()   # delivered around


@pytest.mark.parametrize("name", sorted(BANK_CASES) + sorted(SPOOF_CASES))
def test_banked_ticks_fault_case_matches_reference(name):
    if name in SPOOF_CASES:
        top, faults, part, pubs, times, conv, codec = SPOOF_CASES[name]
    else:
        (top, faults, part, pubs, times, conv), codec = BANK_CASES[name], None
    pair = FaultPair(top, faults, bank=BANK, codec=codec, partition=part)
    report = run_schedule(pair, pubs, times, conv)
    assert report["rejects"].dtype == np.int32
    if name in SPOOF_CASES:
        check_spoof(name, pair, report)
        # one spoof draw per round, at the round's own index, take_link's shape
        n, slots, chunks = pair.t.bank_state.have.shape
        assert pair.draws.calls == [("spoof", i, (n, n, slots * chunks))
                                    for i in range(pair.t.edge_draws)]
    else:
        check_role(name, pair)
        assert report["rejected_total"] == 0


def test_all_honest_banked_is_the_unfaulted_run():
    top, faults, part, pubs, times, conv = BANK_CASES["all_honest"]
    runs = [FaultPair(top, f, bank=BANK, partition=part, reference=False)
            for f in (None, faults)]
    for pair in runs:
        run_schedule(pair, pubs, times, conv)
    a, b = runs[0].t, runs[1].t
    for x, y in zip(a.replicas.dags + a.bank_state, b.replicas.dags + b.bank_state):
        assert torch.equal(x, y)
    assert runs[1].draws.calls == [] and a.bytes_sent() > 0
    assert not b.fault_state.rejects.any() and (b.rejection_credit() == 1.0).all()
