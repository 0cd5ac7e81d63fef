"""The FL systems of Section V, sharing one task/population/latency model,
on one device.

``run_dagfl`` drives Algorithm 2 over one instantly consistent ledger:
iteration starts are Poisson arrivals ("one node on average ready per
second"); an iteration is prepared (stages 1-3) at its start t0 and
committed (stage 4) at t1 = t0 + h, with h from the Table-I
``LatencyModel``. The controller (Algorithm 1) checks every ``eval_every``
commits.

The baselines share the task, the population and the latency model:

* Google FL       — synchronous rounds of 10, FederatedAveraging [1]; the
                    cohort's transfers serialize over the shared 100 Mbps
                    medium, which makes its rounds the slowest (Table II).
* Asynchronous FL — the server mixes each upload into the global model [7].
* Block FL        — 5 miner groups, candidate blocks (5 tx or 10 s), PoW [3].

Their model averages divide by a tensor filled on the device, an IEEE
division on the CPU and on a card alike (a Python scalar divisor is a
reciprocal multiply on a card).

Draws. The reference draws each iteration's tip-selection uniforms from
``split(PRNGKey(seed * 100003 + i))[0]`` and each controller check's from
``PRNGKey(done)``; PyTorch cannot reproduce threefry, so every draw goes
through one function, ``draw(stream, index) -> (cap,) f32 in [1e-9, 1)``
with stream "prepare" (index i) or "check" (index done). By default it is
``torch_uniform_draw``; the tests pass the reference's draws instead. Host
numpy randomness (Poisson starts, node choice, node batches) is the
reference's, bit for bit.

``run_dagfl_gossip`` runs the same loop with each node against its own
ledger replica, synced by anti-entropy gossip over an overlay
(``repro_torch.net``); its edge draws go through ``edge_draw`` the same way
(``repro_torch.net.gossip``). With ``bank_gossip`` the model payloads travel
too, priced per link (``repro_torch.net.bank``), and a node sees only the
transactions whose models it has received. With ``obs`` the overlay's
telemetry runs in every loop and ``extras["obs"]`` holds the drained
``ObsReport`` (``repro_torch.obs``). With ``faults`` adversary roles act in
the overlay (``repro_torch.net.faults``; its draws go through
``fault_draw``), the rejection credit biases tip selection, and
``extras["fault_report"]`` holds the post-mortem. With ``serve`` (events
engine) every node also serves Poisson inference requests from its gated
view (``repro_torch.net.serve``; arrivals through ``serve_draw``) and
``extras["serve_report"]`` holds the throughput and staleness-at-serve.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import DagFLConfig
from repro_torch.core import anomaly
from repro_torch.core.aggregation import unflatten_params
from repro_torch.core.anomaly import contribution_rates
from repro_torch.core.consensus import commit_prepared, make_dagfl_stages
from repro_torch.core.controller import Controller
from repro_torch.device import resolve_device
from repro_torch.fl.latency import LatencyModel
from repro_torch.fl.nodes import SimNode
from repro_torch.fl.tasks import make_epoch_train
from repro_torch.net import gossip as gossip_lib
from repro_torch.net import replica as replica_lib
from repro_torch.net import serve as serve_lib
from repro_torch.net import topology as topo_lib
from repro_torch.obs import trace as obs_trace

UniformDraw = Callable[[str, int], torch.Tensor]


@dataclass
class SimConfig:
    iterations: int = 400
    eval_every: int = 25
    minibatch: int = 32
    steps_per_iter: int = 4       # minibatches per 'iteration' (one local epoch)
    val_size: int = 64            # node-local validation batch (fixed shape)
    seed: int = 0
    async_mix: float = 0.5        # [7]-style server mixing coefficient
    block_margin: float = 0.2     # miner drops tx if acc < global_acc - margin
                                  # (loose: catches poisoned models, not the
                                  #  normal non-IID accuracy dip)
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
    """One instantly-consistent global DAG — the paper's idealized runtime.

    The loop's backend hooks (``advance``, ``on_start``, ``on_commit``,
    ``fault_bias``, ``observe``, ``extras``) are no-ops here, so
    ``run_dagfl`` is what it was before the gossip backend shared the loop.
    """

    name = "dagfl"

    def __init__(self, state, commit_fn):
        self.dag, self.bank = state.dag, state.bank
        self._commit = commit_fn

    def view(self, node_id):
        return self.dag

    def advance(self, t):
        pass

    def on_start(self, node_id, t0, t1):
        pass

    def on_commit(self, node_id, t1):
        pass

    def fault_bias(self):
        return None

    def commit(self, node_id, t1, prepared):
        self.dag, self.bank = self._commit(self.dag, self.bank, node_id, t1, prepared)

    def union_dag(self):
        return self.dag

    def observe(self, done, t1, union):
        pass

    def extras(self, union):
        return {}


def _run_dagfl_events(task, nodes, dcfg, sim, global_val, weighted, make_backend,
                      device, draw: Optional[UniformDraw]):
    """The event loop shared by ``run_dagfl`` and ``run_dagfl_gossip``:
    prepare (stages 1-3) at start time t0, commit (stage 4) at completion
    t1 = t0 + h — in-flight iterations overlap, so tips accumulate to the
    Eq.-4 equilibrium instead of being consumed serially. The backend
    decides what ledger state a node sees (global vs its own replica) and
    is advanced to each start and commit time (span "advance"); one copy of
    the loop keeps the gossip system's ideal-wire limit equal to the shared
    ledger."""
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
        } | backend.extras(union)

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
        with clock("advance"):
            backend.advance(t1)
        with clock("commit"):
            backend.commit(nid, f32(t1), prepared)
        backend.on_commit(nid, t1)
        done += 1
        if done == sim.iterations // 2 and not mid_snapshot:
            mid_snapshot.update(_counter_snapshot(backend.union_dag()))

    def _check(t1):
        nonlocal state
        with clock("check"):
            union = backend.union_dag()
            state.dag, state.bank = union, backend.bank
            state = ctrl.check(state, draw("check", done), float(t1) + 1e-3, gv)
            curve.append((done, t1, state.best_accuracy))
            backend.observe(done, t1, union)

    for i, t0 in enumerate(starts):
        while pending and pending[0][0] <= t0:
            t1, _, nid, prepared = heapq.heappop(pending)
            _commit_one(t1, nid, prepared)
            if done % sim.eval_every == 0:
                _check(t1)
        with clock("advance"):
            backend.advance(t0)
        node = nodes[rng.integers(0, N)]
        lazy = node.behavior == "lazy"
        t1 = t0 + lat.dagfl_iteration(node.node_id, lazy=lazy)
        backend.on_start(node.node_id, t0, t1)
        fn = prep_lazy if lazy else prep_normal
        bias = bd_bias if node.behavior == "backdoor" else zero_bias
        fb = backend.fault_bias()
        if fb is not None:
            bias = bias + fb
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


# ---------------------------------------------------------------------------
# DAG-FL over a gossip overlay (repro_torch.net)
# ---------------------------------------------------------------------------


def _gossip_commit(dag, bank, node_id, t_publish, prepared, seq):
    """Stage-4 commit against a node's LOCAL replica, at a global row.

    The same ``commit_prepared`` body as the shared ledger, addressed by
    ``replica.global_row`` instead of the replica-local count, so every
    replica stores this transaction at the same slot and ``dag.merge`` can
    reconcile by identity.
    """
    slot, new_count = replica_lib.global_row(dag, seq)
    return commit_prepared(dag, bank, node_id, t_publish, prepared, slot=slot,
                           new_count=new_count)


class _GossipLedger:
    """Per-node replicas over a gossip overlay (``repro_torch.net``)."""

    name = "dagfl_gossip"

    def __init__(self, state, topology, gossip, partition, bank_gossip=None, edge_draw=None,
                 obs=None, faults=None, fault_draw=None, serve=None, serve_draw=None):
        self.net = gossip_lib.GossipNetwork(state.dag, state.bank, topology, gossip, partition,
                                            bank_cfg=bank_gossip, obs_cfg=obs,
                                            faults_cfg=faults, serve_cfg=serve,
                                            edge_draw=edge_draw, fault_draw=fault_draw,
                                            serve_draw=serve_draw)
        self.capacity = int(state.dag.publisher.shape[0])
        self.seq = int(state.dag.count)       # genesis consumed sequence 0
        # distinct approvals issued, counted on the device, read once in extras
        self._issued = torch.zeros((), dtype=torch.int64, device=self.net.device)
        self.divergence = []
        self.bank_lag = []

    @property
    def bank(self):
        return self.net.bank

    def _replica(self, node_id):
        # views into the stack: read and consumed before the next write
        return replica_lib.read_replica(self.net.replicas, node_id)

    def view(self, node_id):
        # with the bank gossiped, the node's usable view: rows whose model
        # chunks have not arrived are masked out, so tip selection (and
        # hence approval) waits for the payload
        if self.net.bank_cfg is not None:
            return self.net.read_view(node_id)
        return self._replica(node_id)

    def advance(self, t):
        self.net.advance(t)

    def on_start(self, node_id, t0, t1):
        # the iteration's span for the event trace (no-op without telemetry)
        self.net.trace_span(t0, obs_trace.KIND_PUBLISH, node_id, node_id, t1 - t0)

    def on_commit(self, node_id, t1):
        # the landed transaction's span (arg: its global sequence number);
        # t1 is the host's instant, not the f32 tensor the commit took
        self.net.trace_span(t1, obs_trace.KIND_COMMIT, node_id, node_id, float(self.seq - 1))

    def fault_bias(self):
        """(N+1,) log-credit tip-selection bias from digest rejections, on the
        device: ``anomaly.rejection_credit`` of the fault layer's cumulative
        rejection matrix, with a trailing 1.0 for publisher -1 (genesis). A
        clean sender's credit is exactly 1.0, so its bias is an exact 0 and
        an attack-free trajectory is untouched; a spoofer's collapses toward
        the floor. None without a fault-state carry."""
        fstate = self.net.fault_state
        if fstate is None:
            return None
        credit = anomaly.rejection_credit(fstate.rejects)
        return torch.log(torch.cat([credit, torch.ones((1,), device=credit.device)]))

    def commit(self, node_id, t1, prepared):
        dag_i = self._replica(node_id)
        # a credit is "issued" only when this node was not already an
        # approver of the row in its own replica — publish_at's predicate,
        # so in the ideal-wire limit issued == what survives the union
        rows = prepared.chosen_rows
        credited = dag_i.approvers[rows.clamp(min=0).long(), node_id]
        self._issued += ((rows >= 0) & ~credited).sum()
        # wire compression: encode against the slot's content before the
        # overwrite, store (and tag) the DECODED wire values, so the codec's
        # error enters training once, here, and digest the ENCODED form. The
        # identity codec skips all of it (the reference tests is_identity,
        # not codec_key: a ratio-1.0 topk still encodes)
        slot = self.seq % self.capacity
        codec = self.net.bank_cfg.codec if self.net.bank_cfg is not None else None
        if codec is not None and not codec.is_identity:
            # views of the slot's row, read in stream order before the write
            # below (an int index: no host-to-device copy, no sync)
            base = unflatten_params(self.net.bank.rows[slot], self.net.bank.shapes)
            # int8/int4 on a card: one launch encodes and decodes
            enc, decoded = codec.encode_decode(prepared.new_params, base)
            prepared = prepared._replace(new_params=decoded)
        else:
            enc = prepared.new_params
        dag_i, bank = _gossip_commit(dag_i, self.net.bank, node_id, t1, prepared, self.seq)
        self.net.write(node_id, dag_i, bank)
        # transport accounting: the committer holds its own payload's chunks;
        # the ring-reused slot's old content leaves everyone else
        self.net.bank_commit(node_id, slot, enc)
        self.seq += 1

    def union_dag(self):
        return self.net.union()

    def observe(self, done, t1, union):
        self.divergence.append((done, float(t1), int(self.net.missing_rows(union).max())))
        if self.net.bank_cfg is not None:
            self.bank_lag.append((done, float(t1), int(self.net.missing_chunks().max())))

    def extras(self, union):
        out = {}
        replicas = self.net.replicas
        if self.net.bank_cfg is not None:
            out = {
                # payload transport: chunks still owed vs what the run paid
                "bank_missing_final": self.net.missing_chunks(),
                "bank_bytes_sent": self.net.bytes_sent(),
                "bank_lag_curve": np.asarray(self.bank_lag, dtype=np.float64),
            }
            replicas = replicas._replace(bank_state=replica_lib.snapshot(replicas.bank_state))
        if self.net.obs_cfg is not None:
            # drained telemetry: metric series, trace, histograms, dispatches
            out["obs"] = self.net.obs_report()
        if self.net.faults_cfg is not None:
            # the adversary post-mortem: roles, rejections, quarantine, ASR
            out["fault_report"] = self.net.fault_report()
        sr = self.net.serve_report()
        if sr is not None:
            # per-node throughput and staleness-at-serve (serve.report)
            out["serve_report"] = sr
        return out | {
            # a copy: the replicas are written in place
            "replicas": replicas._replace(dags=replica_lib.snapshot(replicas.dags)),
            "sync_rounds": self.net.rounds_run,
            "device_calls": self.net.device_calls,
            "dispatch_counts": dict(self.net.dispatch_counts),
            "events_processed": self.net.events_processed,
            "events_capped": self.net.events_capped,
            "edge_draws": self.net.edge_draws,
            "synced_final": self.net.synced(),
            "missing_rows_final": self.net.missing_rows(union),
            "approvals_issued": int(self._issued),
            "approvals_in_union": int((union.approval_count * (union.publisher >= 0)).sum()),
            "divergence_curve": np.asarray(self.divergence, dtype=np.float64),
        }


def run_dagfl_gossip(
    task,
    nodes: List[SimNode],
    dcfg: DagFLConfig,
    sim: SimConfig,
    global_val: Dict[str, np.ndarray],
    weighted: bool = False,
    topology: Optional[topo_lib.Topology] = None,
    gossip: Optional[gossip_lib.GossipConfig] = None,
    partition: Optional[gossip_lib.PartitionSchedule] = None,
    mesh=None,
    bank_gossip=None,
    engine: Optional[str] = None,
    obs=None,
    faults=None,
    serve=None,
    device="cuda",
    draw: Optional[UniformDraw] = None,
    edge_draw: Optional[gossip_lib.EdgeDraw] = None,
    fault_draw=None,
    serve_draw=None,
) -> SimResult:
    """DAG-FL where each node runs Algorithm 2 against its own DAG replica.

    ``prepare`` (stages 1-3) reads the node's LOCAL view at iteration start;
    ``commit`` (stage 4) publishes locally; anti-entropy sync ticks are
    interleaved into the event timeline (``GossipNetwork.advance``). The
    external agent E evaluates the union of all replicas — with an ideal
    wire (``sync_period <= 0``, drop 0, connected overlay) this is exactly
    ``run_dagfl``. Defaults: ``full(len(nodes))``, ``GossipConfig(
    sync_period=1.0, seed=sim.seed)`` (ticks engine, fused round).

    ``bank_gossip`` (a ``repro_torch.net.bank.BankGossipConfig``) gossips the
    model bank too: each commit's payload travels in content-addressed
    chunks at the topology's per-link bandwidth, a node's view shows only
    rows whose payload has arrived, and ``extras`` gains
    ``bank_missing_final``, ``bank_bytes_sent`` and ``bank_lag_curve``.

    With ``bank_gossip.codec`` (a ``repro_torch.kernels.delta_codec.
    DeltaCodec``) each commit is encoded against its slot's last content
    (one codec kernel launch), the store keeps the decoded values and the
    chunks are priced at their encoded size.

    ``engine`` overrides the transport clock (``GossipConfig.engine``):
    "ticks" is the quantised stride model; "events" runs the continuous-time
    engine (``repro_torch.net.events``): each link delivers at its own
    latency, and with the bank, chunks drain at whole-chunk instants. With a
    uniform delay equal to a dyadic sync period the two engines are bitwise
    identical. ``extras["events_processed"]`` counts the event batches.

    ``draw``, ``edge_draw``, ``fault_draw`` and ``serve_draw`` replace the
    tip-selection, edge, fault and arrival draws (``run_dagfl``,
    ``repro_torch.net.gossip``, ``repro_torch.net.faults``,
    ``repro_torch.net.serve``).

    ``obs`` (a ``repro_torch.obs.ObsConfig``) turns on the overlay's
    telemetry: metric series, the event trace (with the ledger's PUBLISH and
    COMMIT spans) and, with ``ObsConfig.hist``, the streaming histograms,
    collected in every round as pure reads and drained into
    ``extras["obs"]`` (an ``ObsReport``; ``repro_torch.obs.export`` writes
    it as a Chrome trace or JSONL). The obs-on run is bitwise the obs-off
    run.

    ``faults`` (a ``repro_torch.net.faults.FaultConfig``) assigns adversary
    roles in the overlay, on either engine, bankless or banked, with a codec
    and with ``obs``: crashes, eclipses, selective forwarding and sybil
    forgery on the edges and rows; with the bank, spoofed payloads against
    digest verification, back-off and quarantine. Each sender's rejection
    credit biases tip selection (``fault_bias``: an exact 0 for a clean
    sender, so ``faults=None`` and an all-honest config give the same run),
    and ``extras["fault_report"]`` holds roles, rejections, quarantined
    links and the attack-success numerator.

    ``serve`` (a ``repro_torch.net.serve.ServeConfig``, events engine only)
    adds Poisson inference requests at every node, batched into its slots
    and served from its availability-gated view, so the staleness a request
    sees is the transport's doing; ``extras["serve_report"]`` holds the
    per-node throughput and the staleness samples. Serving only reads the
    ledger: the training run is the serve-free one, and ``serve=None`` or a
    rate of 0 gives no report.

    ``mesh`` is not ported yet and raises ``NotImplementedError``, alone or
    with any other option.
    """
    gossip_lib._unported(mesh=(mesh, "ROADMAP A.12"))
    if topology is None:
        topology = topo_lib.full(len(nodes))
    if gossip is None:
        gossip = gossip_lib.GossipConfig(sync_period=1.0, seed=sim.seed)
    if engine is not None:
        gossip = dataclasses.replace(gossip, engine=engine)
    if serve_lib.serve_key(serve) is not None:
        serve_lib.validate_serve(serve, gossip.engine)
    return _run_dagfl_events(
        task, nodes, dcfg, sim, global_val, weighted,
        lambda state, commit_fn: _GossipLedger(state, topology, gossip, partition,
                                               bank_gossip=bank_gossip, edge_draw=edge_draw,
                                               obs=obs, faults=faults, fault_draw=fault_draw,
                                               serve=serve, serve_draw=serve_draw),
        device, draw,
    )


# ---------------------------------------------------------------------------
# Google FL (synchronous rounds)
# ---------------------------------------------------------------------------


def _average(models: List[Dict[str, torch.Tensor]], device) -> Dict[str, torch.Tensor]:
    """The reference's ``sum(x.astype(f32) for x in xs) / len(xs)`` leaf by
    leaf: the models added in order, then one IEEE division by a tensor
    filled on the device."""
    n = torch.full((), float(len(models)), dtype=torch.float32, device=device)
    return {name: sum(m[name].float() for m in models) / n for name in models[0]}


def run_google(
    task, nodes: List[SimNode], dcfg: DagFLConfig, sim: SimConfig,
    global_val: Dict[str, np.ndarray], device="cuda",
) -> SimResult:
    """Google FL on ``device`` (CUDA unless asked for the CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(sim.seed)
    lat = LatencyModel.create(dcfg, sim.seed)
    gv = _tb(global_val, dev)
    N, cohort = len(nodes), lat.google_cohort
    params = task.init(sim.seed, dev)
    train = make_epoch_train(task)

    t, done, curve, lats = 0.0, 0, [], []
    while done < sim.iterations:
        sel = rng.choice(N, size=cohort, replace=False)
        # shared-medium: cohort downloads then uploads serialize (2*c*tx);
        # training runs in parallel (max d0)
        d0s = [0.0 if nodes[s].behavior == "lazy" else lat.d0(s) for s in sel]
        round_time = 2 * cohort * lat.tx_time() + max(d0s)
        locals_ = []
        for s in sel:
            node = nodes[s]
            if node.behavior == "lazy":
                locals_.append(params)                    # re-uploads the global
            else:
                p, _ = train(params, _tb(node.epoch(sim.steps_per_iter, sim.minibatch), dev))
                locals_.append(p)
        params = _average(locals_, dev)
        t += round_time
        done += cohort
        lats.extend([round_time] * cohort)               # every member waits the round
        if (done // cohort) % max(sim.eval_every // cohort, 1) == 0 or done >= sim.iterations:
            curve.append((done, t, float(task.eval_fn(params, gv))))

    it_arr, t_arr, a_arr = map(np.asarray, zip(*curve))
    return SimResult("google", it_arr, t_arr, a_arr, float(np.mean(lats)), params)


# ---------------------------------------------------------------------------
# Asynchronous FL (server-side mixing, Xie et al. [7])
# ---------------------------------------------------------------------------


def run_async(
    task, nodes: List[SimNode], dcfg: DagFLConfig, sim: SimConfig,
    global_val: Dict[str, np.ndarray], device="cuda",
) -> SimResult:
    """Asynchronous FL on ``device`` (CUDA unless asked for the CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(sim.seed)
    lat = LatencyModel.create(dcfg, sim.seed)
    gv = _tb(global_val, dev)
    N = len(nodes)
    params = task.init(sim.seed, dev)
    train = make_epoch_train(task)
    mix = sim.async_mix

    starts = _poisson_starts(rng, dcfg.arrival_rate, sim.iterations)
    curve, lats = [], []
    for i, t0 in enumerate(starts):
        node = nodes[rng.integers(0, N)]
        lazy = node.behavior == "lazy"
        t1 = t0 + lat.async_iteration(node.node_id, lazy=lazy)
        if lazy:
            local = params
        else:
            local, _ = train(params, _tb(node.epoch(sim.steps_per_iter, sim.minibatch), dev))
        params = {
            name: ((1 - mix) * g.float() + mix * local[name].float()).to(g.dtype)
            for name, g in params.items()
        }
        lats.append(t1 - t0)
        if (i + 1) % sim.eval_every == 0 or i == sim.iterations - 1:
            curve.append((i + 1, t1, float(task.eval_fn(params, gv))))

    it_arr, t_arr, a_arr = map(np.asarray, zip(*curve))
    return SimResult("async", it_arr, t_arr, a_arr, float(np.mean(lats)), params)


# ---------------------------------------------------------------------------
# Block FL (miners + PoW, Kim et al. [3])
# ---------------------------------------------------------------------------


def run_block(
    task, nodes: List[SimNode], dcfg: DagFLConfig, sim: SimConfig,
    global_val: Dict[str, np.ndarray], num_miners: int = 5, device="cuda",
) -> SimResult:
    """Block FL on ``device`` (CUDA unless asked for the CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(sim.seed)
    lat = LatencyModel.create(dcfg, sim.seed)
    gv = _tb(global_val, dev)
    N = len(nodes)
    params = task.init(sim.seed, dev)
    train = make_epoch_train(task)

    miner_of = {i: i % num_miners for i in range(N)}
    collected: List[List[Any]] = [[] for _ in range(num_miners)]
    first_ts: List[Optional[float]] = [None] * num_miners
    pow_until: List[float] = [0.0] * num_miners          # busy mining until t
    global_acc = float(task.eval_fn(params, gv))

    starts = _poisson_starts(rng, dcfg.arrival_rate, sim.iterations)
    curve, lats, dropped = [], [], 0
    for i, t0 in enumerate(starts):
        node = nodes[rng.integers(0, N)]
        m = miner_of[node.node_id]
        lazy = node.behavior == "lazy"
        t1 = t0 + lat.block_iteration(node.node_id, lazy=lazy)
        lats.append(t1 - t0)
        if lazy:
            local = params
        else:
            local, _ = train(params, _tb(node.epoch(sim.steps_per_iter, sim.minibatch), dev))

        if t1 < pow_until[m]:
            dropped += 1                                  # miner busy mining: tx lost
        else:
            # miner validates with the full test set (Section V.A.1)
            acc = float(task.eval_fn(local, gv))
            if acc >= global_acc - sim.block_margin:
                collected[m].append(local)
                if first_ts[m] is None:
                    first_ts[m] = t1
            # block trigger: 5 tx or 10 s since first
            if collected[m] and (
                len(collected[m]) >= lat.block_collect
                or t1 - (first_ts[m] or t1) >= lat.block_timeout
            ):
                mine = lat.pow_time(rng)
                pow_until[m] = t1 + mine
                # the block extends the chain: previous global is a member of
                # the average (keeps small blocks from thrashing the model)
                params = _average([params] + collected[m], dev)
                global_acc = float(task.eval_fn(params, gv))
                collected[m], first_ts[m] = [], None

        if (i + 1) % sim.eval_every == 0 or i == sim.iterations - 1:
            curve.append((i + 1, t1, global_acc))

    it_arr, t_arr, a_arr = map(np.asarray, zip(*curve))
    return SimResult(
        "block", it_arr, t_arr, a_arr, float(np.mean(lats)), params,
        {"dropped": dropped},
    )


SYSTEMS: Dict[str, Callable] = {
    "dagfl": run_dagfl,
    "dagfl_gossip": run_dagfl_gossip,
    "google": run_google,
    "async": run_async,
    "block": run_block,
}
