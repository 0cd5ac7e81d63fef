"""Inference serving on a card: a small banked serving run on the events
engine equals the same run on the CPU, and the default draws give the same
f32 values on both devices.

Imports no JAX, so it runs on a machine with a card and no JAX
(``python -m pytest --noconftest -m cuda``); it skips without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bank as t_store
from repro_torch.core import dag as t_dag
from repro_torch.net import gossip as t_gossip
from repro_torch.net import replica as t_replica
from repro_torch.net import serve as t_serve
from repro_torch.net import topology as t_topo
from repro_torch.net.bank import BankGossipConfig

CAP, K = 32, 2


def serving_net(device, n=6):
    """A genesis ledger on ``device``, a starved full overlay, the bank and
    serving at 3 requests/s, the edge draws made with numpy."""
    dag = t_dag.empty_dag(CAP, K, n + 1, device=device)
    dag = t_dag.publish(dag, torch.tensor(n, dtype=torch.int32, device=device),
                        torch.zeros((), device=device),
                        torch.full((K,), t_dag.NO_TX, dtype=torch.int32, device=device),
                        0.5, 0.0, torch.zeros((), dtype=torch.int32, device=device))

    def edge_draw(index):
        rng = np.random.default_rng([5, index])
        return torch.from_numpy(rng.random((n, n), dtype=np.float32)).to(device)

    return t_gossip.GossipNetwork(
        dag, t_store.init_bank({"w": torch.zeros(8, device=device)}, CAP),
        t_topo.full(n, link_latency=1.0, bandwidth=64.0),
        t_gossip.GossipConfig(sync_period=1.0, engine="events"),
        bank_cfg=BankGossipConfig(chunks_per_slot=2),
        serve_cfg=t_serve.ServeConfig(rate=3.0, sample_capacity=64), edge_draw=edge_draw)


def drive(net, n=6):
    dev = net.device
    for t_end, base, t0 in ((4.0, 1, 0.25), (8.0, 1 + n, 4.5)):
        for i in range(n):
            seq = base + i
            d = t_replica.publish_local(
                net.read(i), seq, i, torch.tensor(t0 + 0.5 * i, device=dev),
                torch.full((K,), t_dag.NO_TX, dtype=torch.int32, device=dev),
                torch.tensor(0.5, device=dev), torch.tensor(0.0, device=dev), seq % CAP)
            net.write(i, d)
            net.bank_commit(i, seq % CAP, {"w": torch.full((8,), float(seq), device=dev)})
        net.advance(t_end)
    return net


@pytest.mark.cuda
def test_card_serving_run_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, cpu = drive(serving_net("cuda")), drive(serving_net("cpu"))
    assert card.serve_state.served.is_cuda
    for x, y in zip(card.replicas.dags + card.bank_state, cpu.replicas.dags + cpu.bank_state):
        assert torch.equal(x.cpu(), y)
    for name in ("time", "valid"):
        assert torch.equal(getattr(card._equeue, name).cpu(), getattr(cpu._equeue, name))
    rep, want = card.serve_report(), cpu.serve_report()
    assert rep.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_equal(rep[key], value, err_msg=key)
    assert rep["served_total"] > 0 and rep["staleness_max"] > 0 and rep["samples_dropped"] > 0
    assert card.events_processed == cpu.events_processed


@pytest.mark.cuda
def test_card_default_draws_equal_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 1024
    for count in (0, 1, 17, 4095, 2 ** 31 - 1):
        counts = torch.full((n,), count, dtype=torch.int32)
        a = t_serve.torch_serve_draw(11, 13, n, "cuda")(counts.cuda())
        b = t_serve.torch_serve_draw(11, 13, n, "cpu")(counts)
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)), count
