"""The port's ``launch/serve.py::SlotServer`` against the reference's.

The same reduced qwen3-0.6b parameters (the reference's, through
``params_from_jax``) and the same prompts go into both servers; the port
must give the same tokens in the same number of ticks with the same cache
length. Greedy tokens are compared only where the comparison is defined:
every argmax the reference takes has a top-2 logit gap above the logits'
1e-4 tolerance, and the test asserts that gap.

Both servers share one cache length across slots, and prefill never sets
it (the reference's ``_write_slot`` skips leaves of fewer than two
dimensions): it reads 0 after admitting an 8-token prompt and 1 after one
tick, so the first tick decodes at position 0. The port reproduces it.

Then the four slot mechanics of ``tests/test_serve_slots.py`` on the port.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch.serve import Request as JRequest
from repro.launch.serve import SlotServer as JSlotServer
from repro.models import build_model as j_build
from repro_torch.configs import ARCHS
from repro_torch.launch.serve import Request, SlotServer, serve
from repro_torch.models.transformer import params_from_jax

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = ARCHS["qwen3-0.6b"].reduced()
    jparams = j_build(J_ARCHS["qwen3-0.6b"].reduced()).init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, jparams, params


def prompts(cfg, n, prompt_len, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32) for _ in range(n)]


def top2_gap(logits) -> float:
    top = np.sort(np.asarray(logits, np.float32).reshape(-1, logits.shape[-1]), axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def record_reference_gaps(server, gaps):
    """Wrap the reference server's jitted prefill and decode to record the
    smallest top-2 gap of every greedy step they feed."""
    prefill, decode = server._prefill, server._decode

    def rec_prefill(p, t):
        logits, cache = prefill(p, t)
        gaps.append(top2_gap(logits[0, -1]))
        return logits, cache

    def rec_decode(p, t, c):
        logits, cache = decode(p, t, c)
        active = [s for s, r in enumerate(server.active) if r is not None]
        gaps.append(top2_gap(np.asarray(logits)[active, 0]))
        return logits, cache

    server._prefill, server._decode = rec_prefill, rec_decode


@pytest.mark.parametrize("slots,n,prompt_len,max_new,seed", [
    (2, 3, 8, 4, 0),          # tests/test_serving.py's run
    (3, 7, 5, 6, 1),
    (1, 2, 12, 3, 2),
])
def test_port_serves_the_references_tokens(setup, slots, n, prompt_len, max_new, seed):
    cfg, jparams, params = setup
    max_len = prompt_len + max_new + 2
    jserver = JSlotServer(J_ARCHS["qwen3-0.6b"].reduced(), jparams, slots=slots,
                          max_len=max_len)
    gaps = []
    record_reference_gaps(jserver, gaps)
    tserver = SlotServer(cfg, params, slots=slots, max_len=max_len)
    jreqs = [JRequest(i, p, max_new) for i, p in enumerate(prompts(cfg, n, prompt_len, seed))]
    treqs = [Request(i, p, max_new) for i, p in enumerate(prompts(cfg, n, prompt_len, seed))]

    pending = list(jreqs)
    jticks = 0
    while pending or any(jserver.active):
        while pending and jserver.admit(pending[0]):
            pending.pop(0)
        jserver.tick()
        jticks += 1
        assert jticks < 100
    tticks = serve(tserver, treqs)

    assert min(gaps) > LOGIT_TOL
    assert tticks == jticks
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    lengths = np.asarray(jserver.cache["stack"].length)
    assert np.all(lengths == lengths[0]) and tserver.length == int(lengths[0])


def test_shared_length_is_not_set_by_prefill(setup):
    """Quirk of the reference, reproduced: length 0 before an admit, 0 after
    admitting an 8-token prompt, 1 after one tick, on both servers."""
    cfg, jparams, params = setup
    jserver = JSlotServer(J_ARCHS["qwen3-0.6b"].reduced(), jparams, slots=2, max_len=24)
    tserver = SlotServer(cfg, params, slots=2, max_len=24)
    seen = []
    for server, req in ((jserver, JRequest), (tserver, Request)):
        before = server.cache["stack"].length
        server.admit(req(0, prompts(cfg, 1, 8)[0], max_new=4))
        admitted = server.cache["stack"].length
        server.tick()
        seen.append([np.asarray(x).reshape(-1)[0] for x in
                     (before, admitted, server.cache["stack"].length)])
    assert [int(x) for x in seen[0]] == [int(x) for x in seen[1]] == [0, 0, 1]


# ---------------------------------------------------------------------------
# the slot mechanics (tests/test_serve_slots.py) on the port
# ---------------------------------------------------------------------------


def make_server(setup, slots=2, max_len=24):
    cfg, _, params = setup
    return SlotServer(cfg, params, slots=slots, max_len=max_len)


def make_req(setup, rid, prompt_len=8, max_new=4):
    cfg = setup[0]
    rng = np.random.default_rng(rid)
    return Request(rid, rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32),
                   max_new=max_new)


def test_admit_prefills_into_free_slot(setup):
    server = make_server(setup, slots=2)
    r0, r1, r2 = (make_req(setup, i) for i in range(3))
    assert server.admit(r0)
    assert len(r0.out) == 1
    assert server.active[0] is r0 and server.active[1] is None
    assert int(server.tokens[0, 0]) == r0.out[-1]
    assert server.admit(r1)
    assert server.active[1] is r1
    assert not server.admit(r2)
    assert len(r2.out) == 0


def test_tick_decodes_all_active_slots_in_lockstep(setup):
    server = make_server(setup, slots=2)
    r0 = make_req(setup, 0, max_new=8)
    r1 = make_req(setup, 1, max_new=8)
    server.admit(r0)
    server.admit(r1)
    n0, n1 = len(r0.out), len(r1.out)
    server.tick()
    assert len(r0.out) == n0 + 1 and len(r1.out) == n1 + 1
    assert int(server.tokens[0, 0]) == r0.out[-1]
    assert int(server.tokens[1, 0]) == r1.out[-1]
    idle = make_server(setup, slots=2)
    tok_before = idle.tokens.clone()
    idle.tick()
    assert torch.equal(idle.tokens, tok_before) and idle.length == 0


def test_done_request_evicts_and_frees_its_slot(setup):
    server = make_server(setup, slots=2)
    req = make_req(setup, 0, max_new=3)
    server.admit(req)
    ticks = 0
    while not req.done:
        server.tick()
        ticks += 1
        assert ticks < 10
    assert len(req.out) >= req.max_new
    assert server.active[0] is None
    assert not any(server.active)


def test_slot_reused_after_completion(setup):
    server = make_server(setup, slots=1)
    first = make_req(setup, 0, max_new=2)
    second = make_req(setup, 1, max_new=2)
    assert server.admit(first)
    assert not server.admit(second)
    while not first.done:
        server.tick()
    assert server.admit(second)
    assert server.active[0] is second
    while not second.done:
        server.tick()
    assert second.done and len(second.out) >= second.max_new
