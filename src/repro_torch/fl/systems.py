"""DAG-FL as the paper simulates it (Section V), on one device.

``run_dagfl`` drives Algorithm 2 over one instantly consistent ledger:
iteration starts are Poisson arrivals ("one node on average ready per
second"); an iteration is prepared (stages 1-3) at its start t0 and
committed (stage 4) at t1 = t0 + h, with h from the Table-I
``LatencyModel``. The controller (Algorithm 1) checks every ``eval_every``
commits. The gossip overlay and the baseline systems come in later slices.

Draws. The reference draws each iteration's tip-selection uniforms from
``split(PRNGKey(seed * 100003 + i))[0]`` and each controller check's from
``PRNGKey(done)``; PyTorch cannot reproduce threefry, so every draw goes
through one function, ``draw(stream, index) -> (cap,) f32 in [1e-9, 1)``
with stream "prepare" (index i) or "check" (index done). By default it is
``torch_uniform_draw``; the tests pass the reference's draws instead. Host
numpy randomness (Poisson starts, node choice, node batches) is the
reference's, bit for bit.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import DagFLConfig
from repro_torch.core.anomaly import contribution_rates
from repro_torch.core.consensus import make_dagfl_stages
from repro_torch.core.controller import Controller
from repro_torch.device import resolve_device
from repro_torch.fl.latency import LatencyModel
from repro_torch.fl.nodes import SimNode
from repro_torch.fl.tasks import make_epoch_train

UniformDraw = Callable[[str, int], torch.Tensor]


@dataclass
class SimConfig:
    iterations: int = 400
    eval_every: int = 25
    minibatch: int = 32
    steps_per_iter: int = 4       # minibatches per 'iteration' (one local epoch)
    val_size: int = 64            # node-local validation batch (fixed shape)
    seed: int = 0
    backdoor_joint_bias: float = 3.0


@dataclass
class SimResult:
    system: str
    iters: np.ndarray
    times: np.ndarray
    accs: np.ndarray
    avg_latency: float            # mean per-iteration latency (Table II)
    final_params: Any
    extras: Dict = field(default_factory=dict)

    def acc_at(self, iteration: int) -> float:
        if len(self.iters) == 0:
            return 0.0
        i = np.searchsorted(self.iters, iteration, side="right") - 1
        return float(self.accs[max(i, 0)])


def _poisson_starts(rng, rate: float, n: int) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, n))


def torch_uniform_draw(seed: int, cap: int, device) -> UniformDraw:
    """Uniforms in [1e-9, 1) from one ``torch.Generator`` on ``device``,
    consumed in call order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(stream: str, index: int) -> torch.Tensor:
        u = torch.rand((cap,), generator=gen, device=device)
        return torch.clamp(u * (1.0 - 1e-9) + 1e-9, min=1e-9)

    return draw


def _tb(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


class _StageClock:
    """Milliseconds spent in each stage of the loop, summed over a run.

    On CUDA a stage is bracketed by two events on the current stream, so its
    time is its span on the device's queue: the device's work for it, or the
    host's enqueueing where the device waits for the host. On the CPU it is
    the host clock. Reading the totals waits for the device.
    """

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans = defaultdict(list)

    @contextmanager
    def __call__(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.spans[name].append((start, end))
        else:
            t = time.perf_counter()
            yield
            self.spans[name].append(1e3 * (time.perf_counter() - t))

    def totals(self) -> Dict[str, Dict[str, float]]:
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, spans in self.spans.items():
            ms = [s.elapsed_time(e) for s, e in spans] if self.cuda else spans
            out[name] = {"count": len(ms), "ms": float(np.sum(ms))}
        return out


def _counter_snapshot(dag) -> Dict[str, np.ndarray]:
    """Raw cumulative counters (Table IV) at a point in time."""
    return dict(
        contribution_m0=dag.contributing_m0.cpu().numpy(),
        contribution_m1=dag.contributing_m1.cpu().numpy(),
        published=dag.published_per_node.cpu().numpy(),
    )


def _late_contributions(dag, mid_snapshot: Dict, extras: Dict) -> None:
    """Second-half contribution rates from a mid-run counter snapshot."""
    if not mid_snapshot:
        return
    now = _counter_snapshot(dag)
    pub_late = now["published"] - mid_snapshot["published"]
    for m in (0, 1):
        c_late = now[f"contribution_m{m}"] - mid_snapshot[f"contribution_m{m}"]
        extras[f"late_contribution_m{m}"] = c_late / np.maximum(pub_late, 1)
    extras["late_published"] = pub_late


def _identity_train(params, batch):
    """Lazy-node 'training' (§V.A): republish the aggregated model as-is."""
    return params, {}


class _SharedLedger:
    """One instantly-consistent global DAG — the paper's idealized runtime."""

    name = "dagfl"

    def __init__(self, state, commit_fn):
        self.dag, self.bank = state.dag, state.bank
        self._commit = commit_fn

    def view(self, node_id):
        return self.dag

    def commit(self, node_id, t1, prepared):
        self.dag, self.bank = self._commit(self.dag, self.bank, node_id, t1, prepared)

    def union_dag(self):
        return self.dag


def _run_dagfl_events(task, nodes, dcfg, sim, global_val, weighted, make_backend,
                      device, draw: Optional[UniformDraw]):
    """The event loop: prepare (stages 1-3) at start time t0, commit
    (stage 4) at completion t1 = t0 + h — in-flight iterations overlap, so
    tips accumulate to the Eq.-4 equilibrium instead of being consumed
    serially. The backend decides what ledger state a node sees."""
    dev = resolve_device(device)
    rng = np.random.default_rng(sim.seed)
    lat = LatencyModel.create(dcfg, sim.seed)
    gv = _tb(global_val, dev)
    N = len(nodes)
    if draw is None:
        draw = torch_uniform_draw(sim.seed, dcfg.capacity, dev)

    def f32(t):
        return torch.tensor(t, dtype=torch.float32, device=dev)

    ctrl = Controller(dcfg, task.eval_fn, device=dev)
    params0 = task.init(sim.seed, dev)
    state = ctrl.genesis(params0, gv)

    prep_normal, commit_fn = make_dagfl_stages(dcfg, task.eval_fn, make_epoch_train(task),
                                               weighted)
    prep_lazy, _ = make_dagfl_stages(dcfg, task.eval_fn, _identity_train, weighted)
    backend = make_backend(state, commit_fn)
    clock = _StageClock(dev)

    def _extras(union):
        return {
            "contribution_m0": contribution_rates(union, 0).cpu().numpy(),
            "contribution_m1": contribution_rates(union, 1).cpu().numpy(),
            "published": union.published_per_node.cpu().numpy(),
            "behaviors": [n.behavior for n in nodes],
            "dag": union,
            "stage_ms": clock.totals(),
            "checks": state.checks,
            "checks_with_tip": state.aggregations,
        }

    if sim.iterations == 0:
        # no Poisson starts -> no commits: report the genesis state
        empty = np.zeros((0,))
        return SimResult(backend.name, empty, empty, empty, 0.0, params0,
                         _extras(backend.union_dag()))

    # joint backdoor attack: backdoor nodes up-weight backdoor publishers
    is_bd = np.array([n.behavior == "backdoor" for n in nodes] + [False])
    bd_bias = torch.tensor(np.where(is_bd, sim.backdoor_joint_bias, 0.0), dtype=torch.float32,
                           device=dev)
    zero_bias = torch.zeros_like(bd_bias)

    starts = _poisson_starts(rng, dcfg.arrival_rate, sim.iterations)
    pending = []        # heap of (t1, seq, node_id, Prepared)
    curve, lats = [], []
    done = 0
    mid_snapshot = {}

    def _commit_one(t1, nid, prepared):
        nonlocal done
        with clock("commit"):
            backend.commit(nid, f32(t1), prepared)
        done += 1
        if done == sim.iterations // 2 and not mid_snapshot:
            mid_snapshot.update(_counter_snapshot(backend.union_dag()))

    def _check(t1):
        nonlocal state
        state.dag, state.bank = backend.union_dag(), backend.bank
        with clock("check"):
            state = ctrl.check(state, draw("check", done), float(t1) + 1e-3, gv)
        curve.append((done, t1, state.best_accuracy))

    for i, t0 in enumerate(starts):
        while pending and pending[0][0] <= t0:
            t1, _, nid, prepared = heapq.heappop(pending)
            _commit_one(t1, nid, prepared)
            if done % sim.eval_every == 0:
                _check(t1)
        node = nodes[rng.integers(0, N)]
        lazy = node.behavior == "lazy"
        t1 = t0 + lat.dagfl_iteration(node.node_id, lazy=lazy)
        fn = prep_lazy if lazy else prep_normal
        bias = bd_bias if node.behavior == "backdoor" else zero_bias
        with clock("prepare"):
            prepared = fn(
                backend.view(node.node_id),
                backend.bank,
                f32(t0),
                draw("prepare", i),
                _tb(node.epoch(sim.steps_per_iter, sim.minibatch), dev),
                _tb(node.val_batch(sim.val_size), dev),
                bias,
            )
        heapq.heappush(pending, (t1, i, node.node_id, prepared))
        lats.append(t1 - t0)
    while pending:
        t1, _, nid, prepared = heapq.heappop(pending)
        _commit_one(t1, nid, prepared)
    _check(t1)

    union = state.dag
    extras = _extras(union)
    _late_contributions(union, mid_snapshot, extras)
    it_arr, t_arr, a_arr = map(np.asarray, zip(*curve))
    return SimResult(
        backend.name, it_arr, t_arr, a_arr, float(np.mean(lats)),
        state.target_model if state.target_model is not None else params0, extras,
    )


def run_dagfl(
    task,
    nodes: List[SimNode],
    dcfg: DagFLConfig,
    sim: SimConfig,
    global_val: Dict[str, np.ndarray],
    weighted: bool = False,
    device="cuda",
    draw: Optional[UniformDraw] = None,
) -> SimResult:
    """DAG-FL on one shared ledger, on ``device`` (CUDA unless asked for the CPU)."""
    return _run_dagfl_events(
        task, nodes, dcfg, sim, global_val, weighted,
        lambda state, commit_fn: _SharedLedger(state, commit_fn), device, draw,
    )
