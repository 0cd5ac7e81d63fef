"""Fault injection through whole runs, against the reference: the fault
telemetry on both engines (the rejected and quarantined series, REJECT
records, final scalars; obs on bitwise obs off), and a short
``run_dagfl_gossip(faults=...)`` on the bench CNN with a spoofer, a
selective forwarder, a sybil and a crash window, where the rejection credit
biases tip selection.

The reference's tip, edge and fault draws are fed to the port. Tolerances:
bitwise for the curve, every integer column, the transport and fault state,
the fault report and the telemetry's integer series and records; the
telemetry's f32 byte sums within 1e-6 relative (``assert_reports_equal``);
trained parameters within 1e-4 (twenty iterations of f32 SGD computed by
two libraries, as in ``tests/test_torch_gossip.py``).
"""
import numpy as np
import pytest
import torch

from repro.fl import experiments as j_exp
from repro.fl import systems as j_sys
from repro.net import bank as j_bank
from repro.net import faults as j_faults
from repro.net import gossip as j_gossip
from repro.net import topology as j_topo
from repro.obs import KIND_REJECT
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys
from repro_torch.net import bank as t_bank
from repro_torch.net import faults as t_faults
from repro_torch.net import gossip as t_gossip
from repro_torch.net import topology as t_topo
from test_torch_bank import assert_state_equal
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_faults import FaultPair, reference_fault_draw, run_schedule
from test_torch_gossip import (INT_FIELDS, assert_dags_equal, reference_draws,
                               reference_edge_draws, seeded_task)
from test_torch_hist import assert_reports_equal

BANK = dict(chunks_per_slot=4)


@pytest.mark.parametrize("engine", ["ticks", "events"])
def test_fault_telemetry_matches_reference(engine):
    """A spoofer on a starved full overlay with telemetry on: the port's
    report equals the reference's, and the obs-on run is bitwise the obs-off
    one."""
    top = ("full", (5,), dict(link_latency=1.0, bandwidth=64.0))
    faults = dict(roles=(0, 0, 0, 0, 4), spoof_rate=1.0, quarantine_after=3)
    on = FaultPair(top, faults, engine=engine, bank=BANK, obs=True)
    off = FaultPair(top, faults, engine=engine, bank=BANK, reference=False)
    for pair in (on, off):
        run_schedule(pair, [(4, 1, 0.2)], range(1, 8), 20.0 if engine == "ticks" else None)
    want, got = on.j.obs_report(), on.t.obs_report()
    assert_reports_equal(got, want)
    assert got.series["rejected"][-1] > 0 and got.series["quarantined"][-1] > 0
    assert (got.trace["kind"] == KIND_REJECT).sum() > 0
    assert got.final["rejected"] > 0 and got.final["quarantined"] > 0
    for x, y in zip(on.t.replicas.dags + on.t.bank_state + on.t.fault_state,
                    off.t.replicas.dags + off.t.bank_state + off.t.fault_state):
        assert torch.equal(x, y)


# eight nodes: a spoofer, a selective forwarder, a sybil, a node dark for [5, 10)
RUN_FAULTS = dict(roles=(4, 0, 3, 0, 5, 0, 1, 0), crash_start=5.0, crash_end=10.0,
                  forward_prob=0.5, spoof_rate=1.0, quarantine_after=2)


def test_run_dagfl_gossip_faults_matches_reference():
    """The starved lossy ring of ``tests/test_torch_bank.py`` with every
    role at once: the curve, the ledgers, transport and fault state, the
    fault report bitwise; parameters within 1e-4."""
    n, seed, gseed = 8, 0, 3
    jt, jn, jg, _ = j_exp.make_cnn_setup(num_nodes=n, seed=seed)
    _, tn, tg, _ = t_exp.make_cnn_setup(num_nodes=n, seed=seed)
    jd, td = j_exp.default_dagfl_config(n), t_exp.default_dagfl_config(n)
    rj = j_sys.run_dagfl_gossip(
        jt, jn, jd, j_sys.SimConfig(iterations=20, eval_every=5, seed=seed), jg,
        topology=j_topo.ring(n, link_latency=1.5, drop=0.3, bandwidth=1e7),
        gossip=j_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        bank_gossip=j_bank.BankGossipConfig(chunks_per_slot=4, slot_bytes=7e6),
        faults=j_faults.FaultConfig(**RUN_FAULTS))
    draws = reference_fault_draw(gseed)
    rt = t_sys.run_dagfl_gossip(
        seeded_task(jt, seed), tn, td, t_sys.SimConfig(iterations=20, eval_every=5, seed=seed),
        tg, topology=t_topo.ring(n, link_latency=1.5, drop=0.3, bandwidth=1e7),
        gossip=t_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        bank_gossip=t_bank.BankGossipConfig(chunks_per_slot=4, slot_bytes=7e6),
        faults=t_faults.FaultConfig(**RUN_FAULTS), device="cpu",
        draw=reference_draws(seed, td.capacity), edge_draw=reference_edge_draws(gseed, n),
        fault_draw=draws)
    assert rt.avg_latency == rj.avg_latency
    for name in ("iters", "times", "accs"):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name), err_msg=name)
    assert_dags_equal(rt.extras["dag"], rj.extras["dag"], INT_FIELDS + ("publish_time",))
    assert_dags_equal(rt.extras["replicas"].dags, rj.extras["replicas"].dags,
                      INT_FIELDS + ("publish_time",))
    assert_state_equal(rt.extras["replicas"].bank_state, rj.extras["replicas"].bank_state)
    for key in ("divergence_curve", "bank_lag_curve", "bank_missing_final",
                "missing_rows_final"):
        np.testing.assert_array_equal(rt.extras[key], np.asarray(rj.extras[key]), err_msg=key)
    for key in ("bank_bytes_sent", "sync_rounds", "device_calls", "dispatch_counts",
                "approvals_issued", "approvals_in_union", "synced_final"):
        assert rt.extras[key] == rj.extras[key], key
    got, want = rt.extras["fault_report"], rj.extras["fault_report"]
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)
    assert got["rejected_total"] > 0 and got["tainted_in_views"].sum() == 0
    assert (got["rejection_credit"][0] < 1.0) and (got["rejection_credit"][1:] == 1.0).all()
    assert {c[0] for c in draws.calls} == {"edges", "spoof"}
    for k in rj.final_params:
        np.testing.assert_allclose(rt.final_params[k].numpy(), np.asarray(rj.final_params[k]),
                                   atol=1e-4, rtol=0)


def test_all_honest_run_is_the_unfaulted_run():
    """``run_dagfl_gossip`` with an all-HONEST config (its zero fault bias
    added every iteration) is bitwise the ``faults=None`` run, floats
    included."""
    n = 6
    out = []
    for faults in (None, t_faults.FaultConfig(roles=(0,) * n)):
        task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=n, seed=1)
        out.append(t_sys.run_dagfl_gossip(
            task, nodes, t_exp.default_dagfl_config(n),
            t_sys.SimConfig(iterations=10, eval_every=5, seed=1), gval,
            topology=t_topo.ring(n, link_latency=1.5, drop=0.3, bandwidth=1e7),
            bank_gossip=t_bank.BankGossipConfig(chunks_per_slot=4, slot_bytes=7e6),
            faults=faults, device="cpu"))
    a, b = out
    np.testing.assert_array_equal(a.accs, b.accs)
    for x, y in zip(a.extras["replicas"].dags + a.extras["replicas"].bank_state,
                    b.extras["replicas"].dags + b.extras["replicas"].bank_state):
        assert torch.equal(x, y)
    for k in a.final_params:
        assert torch.equal(a.final_params[k], b.final_params[k])
    assert "fault_report" not in a.extras and b.extras["fault_report"]["rejected_total"] == 0
