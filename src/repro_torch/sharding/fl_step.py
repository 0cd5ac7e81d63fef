"""DAG-FL over the model zoo: one Algorithm-2 iteration of every node a step.

The port of ``repro.sharding.fl_step``. Node i's model is row i of the
node-stacked parameters (every leaf ``(N, ...)``). One step does:

  1. tip selection   — per-node Gumbel sample of alpha fresh peers from a
                       uniform draw, top-k by last round's score matrix
                       (stages 1 + 3; ``select_peers``),
  2. Eq.-1 aggregation — out_i = sum_j C_ij w_j (``aggregate``): on the card
                       one ``fedavg_gather`` launch a node and a leaf over the
                       k chosen rows, on the CPU the reference's dense
                       product ``C @ flat``,
  3. local training  — a Python loop over the nodes (the reference vmaps):
                       the gradient of ``Model.loss`` by autograd (attention's
                       backward kernel inside), fl_step's own SGD,
  4. validation      — score matrix S[j, i] = acc(model j on node i's val
                       tokens): each node scores ITS OWN new model on every
                       node's shard, one batched forward a node, no gradient,
  5. frontier update — approvals and publish times.

Each stage runs inside a profiler range ``repro_torch.fl_step.<stage>``
(select, aggregate, local_train, score, frontier; ring_select_aggregate on
the ring), which a profiled step reads.

``ring_window = W > 0`` restricts each node's candidates to its W ring
neighbours: selection, Eq. (1) and scoring are W rolls over the node axis,
plain PyTorch as in the reference.

Randomness: the selection's uniform draw ((N, N), or (N, W) on the ring,
in [1e-9, 1)) is a tensor the caller passes, or an int that seeds a torch
generator on the frontier's device (``uniform_draw``). The tests feed the
reference's ``jax.random.uniform(k_sel, ...)`` through the first.

Top-k is the port's stable descending sort (``core/dag.py::top_k``): ties to
the lower index, as ``lax.top_k``; accuracies tie all the time. Means are
XLA's: the f32 sum times the f32 reciprocal of the count.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import DagFLConfig, ModelConfig, TrainConfig
from repro_torch.core.dag import top_k
from repro_torch.device import resolve_device
from repro_torch.kernels.fedavg import fedavg_gather
from repro_torch.models.layers import xla_mean
from repro_torch.optim.optimizers import tree_leaves, tree_map, value_and_grad

NEG_INF = float("-inf")


class Frontier(NamedTuple):
    """Frontier DAG metadata (O(N^2) scalars)."""

    scores: torch.Tensor          # (N, N) f32: S[j, i] = acc(model j, val i)
    publish_time: torch.Tensor    # (N,) f32
    approval_count: torch.Tensor  # (N,) int32 — approvals since last publish
    total_published: torch.Tensor  # (N,) int32
    total_contributing: torch.Tensor  # (N,) int32 (> 0 approvals when republished)
    now: torch.Tensor             # () f32


class Selection(NamedTuple):
    """Stage 1 + 3's choice for every node, in two forms."""

    C: torch.Tensor               # (N, N) f32 row-normalised: Eq. (1)'s dense weights
    slots: torch.Tensor           # (N, k) int32: the chosen nodes (i itself in the fallback)
    weights: torch.Tensor         # (N, k) f32: C[i, slots[i, j]], 0 for a slot without a tip


def init_frontier(num_nodes: int, device="cuda") -> Frontier:
    dev = resolve_device(device)
    n = num_nodes
    return Frontier(
        scores=torch.zeros((n, n), dtype=torch.float32, device=dev),
        publish_time=torch.zeros((n,), dtype=torch.float32, device=dev),
        approval_count=torch.zeros((n,), dtype=torch.int32, device=dev),
        total_published=torch.zeros((n,), dtype=torch.int32, device=dev),
        total_contributing=torch.zeros((n,), dtype=torch.int32, device=dev),
        now=torch.zeros((), dtype=torch.float32, device=dev),
    )


def uniform_draw(shape, draw, device) -> torch.Tensor:
    """The selection's f32 uniform draw in [1e-9, 1): ``draw`` itself when it
    is a tensor (of ``shape``), else drawn from a generator on ``device``
    seeded with the int ``draw``."""
    if isinstance(draw, torch.Tensor):
        if tuple(draw.shape) != tuple(shape):
            raise ValueError(f"the uniform draw has shape {tuple(draw.shape)}, not {shape}")
        return draw.to(device=device, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(int(draw))
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(1e-9, 1.0,
                                                                            generator=gen)


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def _fresh(frontier: Frontier, tau_max: float) -> torch.Tensor:
    return (frontier.now - frontier.publish_time) <= tau_max                # (N,)


def select_peers(frontier: Frontier, alpha: int, k: int, tau_max: float,
                 draw=0) -> Selection:
    """Stages 1 + 3 for every node from the ``(N, N)`` uniform draw (see
    ``uniform_draw``): row-normalised C and its k slots and weights."""
    N = frontier.scores.shape[0]
    dev = frontier.scores.device
    alpha = max(1, min(alpha, N - 1))    # pod-granularity: N can be 2
    k = max(1, min(k, alpha))
    u = uniform_draw((N, N), draw, dev)
    eligible = _fresh(frontier, tau_max)[None, :] & ~torch.eye(N, dtype=torch.bool, device=dev)
    sample_score = torch.where(eligible, _gumbel(u), NEG_INF)
    _, cand = top_k(sample_score, alpha)                                   # (N, alpha)

    # validate candidates with last round's accuracy scores: S[j, i]
    cand_acc = torch.gather(frontier.scores.T, 1, cand)
    cand_ok = torch.gather(eligible, 1, cand)
    cand_acc = torch.where(cand_ok, cand_acc, NEG_INF)
    top_acc, pos = top_k(cand_acc, k)                                      # (N, k)
    chosen = torch.gather(cand, 1, pos)
    valid = torch.isfinite(top_acc)

    onehot = F.one_hot(chosen, N).float()                                  # (N, k, N)
    C = torch.sum(onehot * valid[..., None], dim=1)
    # fall back to self when a node found no usable tip (round 0)
    none = torch.sum(C, dim=1) < 0.5
    C = C + torch.eye(N, device=dev) * none[:, None]
    C = C / torch.clamp(torch.sum(C, dim=1, keepdim=True), min=1e-9)

    nodes = torch.arange(N, device=dev)[:, None]
    slots = torch.where(none[:, None], nodes, chosen).to(torch.int32)
    weights = torch.where(valid, torch.gather(C, 1, chosen), 0.0)
    first = torch.arange(k, device=dev)[None, :] == 0
    weights = torch.where(none[:, None] & first, 1.0, weights)
    return Selection(C, slots, weights)


def aggregate(selection: Selection, stacked: Any, impl: Optional[str] = None,
              dtype=torch.float32) -> Any:
    """Eq. (1): out_i = sum_j C_ij w_j over the node axis of every leaf.

    ``impl``: "gather" — ``fedavg_gather`` (the kernel on the card) a node
    and a leaf, over the k chosen rows with their weights, accumulated in
    f32; "einsum" — the reference's dense ``C @ flat``, the plain version,
    for CPU tensors only. By default the first on the card, the second on
    the CPU. ``dtype=torch.bfloat16`` rounds the weights and the leaf to
    bf16 first, as the reference rounds C and the leaf (an f32 ``dtype``
    reads the leaf in its own dtype: the kernel sums in f32 and rounds the
    output once, as the f32 product and the cast back do).
    """
    on_card = tree_leaves(stacked)[0].device.type == "cuda"
    impl = impl or ("gather" if on_card else "einsum")
    C = selection.C
    N = C.shape[0]
    if impl == "einsum":
        if on_card:
            raise ValueError("aggregate: the einsum is Eq. (1)'s plain version, for CPU tensors; "
                             "on the card Eq. (1) goes through fedavg_gather")

        def avg(leaf):
            flat = leaf.reshape(N, -1).to(dtype)
            out = C.to(dtype) @ flat
            return out.reshape(leaf.shape).to(leaf.dtype)
        return tree_map(avg, stacked)
    if impl != "gather":
        raise ValueError(f"aggregate: unknown impl {impl!r}")
    weights = selection.weights.to(dtype).float()

    def gather(leaf):
        rows = leaf.reshape(N, -1)
        if dtype != torch.float32:
            rows = rows.to(dtype)
        out = torch.stack([fedavg_gather(rows, selection.slots[i], weights[i])
                           for i in range(N)])
        return out.reshape(leaf.shape).to(leaf.dtype)
    return tree_map(gather, stacked)


def _span(stage: str):
    """A profiler range around a stage of the step (a no-op unless a
    profiler records): ``repro_torch.fl_step.<stage>``."""
    return torch.profiler.record_function(f"repro_torch.fl_step.{stage}")


def make_dagfl_train_step(
    model,
    cfg: ModelConfig,
    tcfg: TrainConfig,
    dcfg: DagFLConfig,
    num_nodes: int,
    agg_impl: Optional[str] = None,
    microbatches: int = 1,
    agg_dtype=torch.float32,
    ring_window: int = 0,
):
    """Returns ``step(stacked_params, frontier, batch, val_batch, draw) ->
    (new_params, new_frontier, metrics)``.

    ``batch``: {"tokens", "labels"} ``(N, b, S)``; ``val_batch``:
    {"tokens"} ``(N, vb, S_val)``; tensors or numpy arrays. ``draw``: the
    selection's uniform draw or an int seeding it (``uniform_draw``). §Perf
    knobs as the reference's: ``microbatches`` accumulates f32 gradients over
    sub-batches; ``agg_dtype=torch.bfloat16`` aggregates in bf16; ``agg_impl``
    as ``aggregate``'s ``impl``. ``stacked_params`` is not modified.
    """
    if cfg.frontend_tokens:
        raise NotImplementedError("frontend models wait for ROADMAP A.13, part 4")
    N, W = num_nodes, ring_window
    lr = tcfg.learning_rate

    def node_loss(params, batch):
        total, _ = model.loss(params, batch)
        return total

    def shard_accuracies(params, vt):
        """(n,) accuracy of ``params`` on each shard of ``vt`` (n, vb, S): one
        forward of the n * vb sequences, argmax against the next token."""
        n, vb, s = vt.shape
        flat = vt.reshape(n * vb, s)
        logits, _ = model.forward(params, flat)
        hits = (torch.argmax(logits[:, :-1], dim=-1) == flat[:, 1:]).float()
        return xla_mean(hits.view(n, vb, s - 1), (1, 2))

    def sgd(params, grads):
        return tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype), params, grads)

    def local_train(params, node_batch):
        if microbatches == 1:
            _, grads = value_and_grad(node_loss, params, node_batch)
            return sgd(params, grads)
        size = node_batch["tokens"].shape[0] // microbatches
        gsum = None
        for m in range(microbatches):
            mb = {name: a[m * size:(m + 1) * size] for name, a in node_batch.items()}
            _, grads = value_and_grad(node_loss, params, mb)
            gsum = (tree_map(lambda g: g.float(), grads) if gsum is None
                    else tree_map(lambda a, g: a + g.float(), gsum, grads))
        count = torch.full((), float(microbatches), device=tree_leaves(gsum)[0].device)
        return sgd(params, tree_map(lambda g: g / count, gsum))

    def ring_select_and_aggregate(frontier, draw, stacked):
        """§Perf 'neighborhood tip sampling': each node's candidates are its
        W ring neighbours; Eq. (1) and the approvals are W rolls."""
        dev = frontier.scores.device
        fresh = _fresh(frontier, dcfg.tau_max)
        cand_acc = frontier.scores[:, :W]
        ok = torch.stack([torch.roll(fresh, d, 0) for d in range(1, W + 1)], 1)
        sample = torch.where(ok, _gumbel(uniform_draw((N, W), draw, dev)), NEG_INF)
        _, cand = top_k(sample, min(dcfg.alpha, W))
        acc_sel = torch.where(torch.gather(ok, 1, cand), torch.gather(cand_acc, 1, cand),
                              NEG_INF)
        top_acc, pos = top_k(acc_sel, dcfg.k)
        chosen = torch.gather(cand, 1, pos)                     # (N, k) offsets - 1
        valid = torch.isfinite(top_acc)
        gates = torch.sum(F.one_hot(chosen, W).float() * valid[..., None], 1)     # (N, W)
        none = torch.sum(gates, 1) < 0.5
        gates = gates / torch.clamp(torch.sum(gates, 1, keepdim=True), min=1e-9)

        def agg(leaf):
            lead = (N,) + (1,) * (leaf.ndim - 1)
            wide = leaf.to(agg_dtype)
            out = torch.where(none.reshape(lead), wide, torch.zeros((), dtype=agg_dtype,
                                                                     device=dev))
            for d in range(1, W + 1):
                g = gates[:, d - 1].reshape(lead).to(agg_dtype)
                out = out + g * torch.roll(wide, d, 0)
            return out.to(leaf.dtype)

        # approvals: node j approved once per selector picking offset d
        sel = (gates > 0).to(torch.int32)
        approvals = torch.zeros((N,), dtype=torch.int32, device=dev)
        for d in range(1, W + 1):
            approvals = approvals + torch.roll(sel[:, d - 1], -d, 0)
        return tree_map(agg, stacked), approvals

    def node_params(stacked, i):
        return tree_map(lambda a: a[i], stacked)

    def as_tokens(x, device):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.long)
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)

    def step(stacked_params, frontier: Frontier, batch, val_batch, draw=0):
        dev = frontier.scores.device
        now = frontier.now + 1.0

        if W:
            with _span("ring_select_aggregate"):
                agg_params, approvals = ring_select_and_aggregate(frontier, draw,
                                                                  stacked_params)
            sel = None
        else:
            with _span("select"):        # stages 1+3a: selection from the frontier
                sel = select_peers(frontier, dcfg.alpha, dcfg.k, dcfg.tau_max, draw)
            with _span("aggregate"):     # stage 3b: Eq.-1 aggregation
                agg_params = aggregate(sel, stacked_params, agg_impl, agg_dtype)

        # stage 3c: local training, a node at a time (each graph freed)
        with _span("local_train"):
            tokens, labels = as_tokens(batch["tokens"], dev), as_tokens(batch["labels"], dev)
            new_params = tree_map(torch.empty_like, agg_params)
            for i in range(N):
                trained = local_train(node_params(agg_params, i),
                                      {"tokens": tokens[i], "labels": labels[i]})
                tree_map(lambda dst, src: dst[i].copy_(src), new_params, trained)
                del trained
            del agg_params

        # stages 2/4: validation scores, data-moves-not-models
        with _span("score"), torch.no_grad():
            vt = as_tokens(val_batch["tokens"], dev)                 # (N, vb, S_val)
            if W:
                # ring[i, d - 1] = acc(model_{i-d} on val_i), each on its first sequence
                own = torch.stack([
                    shard_accuracies(node_params(new_params, j), torch.stack(
                        [vt[(j + d) % N, :1] for d in range(1, W + 1)]))
                    for j in range(N)])                          # own[j, d - 1]: val_{j+d}
                ring = torch.stack([torch.roll(own[:, d - 1], d, 0) for d in range(1, W + 1)], 1)
                scores = torch.zeros_like(frontier.scores)
                scores[:, :W] = ring
                mean_acc = xla_mean(ring, (0, 1))
                sel_entropy = torch.zeros((), dtype=torch.float32, device=dev)
            else:
                scores = torch.stack([shard_accuracies(node_params(new_params, j), vt)
                                      for j in range(N)])        # (N_j, N_i)
                approvals = torch.sum(sel.C > 0, dim=0, dtype=torch.int32)
                mean_acc = xla_mean(torch.diagonal(scores), (0,))
                C = sel.C
                sel_entropy = -torch.sum(torch.where(C > 0, C * torch.log(C + 1e-9), 0.0)) / \
                    torch.full((), float(N), device=dev)

        # stage 4: publish (frontier metadata update)
        with _span("frontier"):
            contributed = (frontier.approval_count + approvals) > 0
            new_frontier = Frontier(
                scores=scores,
                publish_time=torch.zeros_like(frontier.publish_time) + now,
                approval_count=torch.zeros_like(frontier.approval_count),
                total_published=frontier.total_published + 1,
                total_contributing=frontier.total_contributing + contributed.to(torch.int32),
                now=now,
            )
        metrics = {"mean_val_acc": mean_acc, "selection_entropy": sel_entropy}
        return new_params, new_frontier, metrics

    return step
