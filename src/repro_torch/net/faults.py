"""Adversarial fault injection for the gossip overlay (§V.4 / Table III).

Port of the reference's fault layer (``repro.net.faults``). Per-node
adversary ROLES act inside the round bodies both engines run
(``GossipNetwork``'s tick rounds and ``repro_torch.net.events``' delivery
batches), and the defenses the paper assumes — digest verification on
receive, re-fetch from alternate holders, quarantine of misbehaving links —
act against them.

Roles (one per node, static for the run):

``ROLE_HONEST``     unchanged.
``ROLE_CRASH``      dark for ``t in [crash_start, crash_end)``: every edge
                    touching the node is cut, then it recovers.
``ROLE_ECLIPSE``    the ``eclipse_target``'s links to non-attackers are cut
                    both ways, so its view is whatever the attackers relay.
``ROLE_SELECTIVE``  forwards each outgoing edge with probability
                    ``forward_prob`` only (a gray hole).
``ROLE_SPOOF``      serves chunk payloads whose bytes do not match the
                    announced digest (rate ``spoof_rate`` per admitted
                    chunk). Needs bank gossip.
``ROLE_SYBIL``      forges the full approver bitset on every row of its own
                    replica before gossiping it.

Defense (``verify_digests=True``, the default): every admitted chunk is
digest-checked on receive (``kernels.chunk_transfer.transfer_verify``) and a
mismatch is dropped before it can set a presence bit; a rejecting link
loses its rolled-over credit and charges the sender one rejection per bad
chunk (the bytes are billed all the same); at ``quarantine_after``
cumulative rejections the link is cut for good and ``transfer_select``'s
striping re-routes the chunks to alternate holders. Cumulative per-sender
rejections feed ``repro_torch.core.anomaly.rejection_credit``, which the FL
loop folds into tip selection. With verification off the corrupted chunks
land and ``FaultState.tainted`` tracks the infection.

Draws. The reference branches its fault draws off each round's sub-key with
``fold_in`` (salt 7 for SELECTIVE, 11 for SPOOF), so they never advance the
main key stream. PyTorch cannot reproduce threefry, so every fault draw goes
through one function, ``fault_draw(stream, index, shape) -> f32 uniforms in
[0, 1)``, with three streams:

  ``"edges"``        SELECTIVE's (N, N) uniforms, both engines; ``index`` is
                     the round's edge-draw index (``GossipNetwork.edge_draws``
                     before the round drew): the reference's
                     ``fold_in(sub, 7)``;
  ``"spoof"``        SPOOF's (R, R, S*C) uniforms on the ticks engine, the
                     same index: ``fold_in(sub, 11)``;
  ``"spoof_batch"``  SPOOF's uniforms on the events engine, where every
                     batch (a drain-only one too) draws from
                     ``fold_in(fold_in(key, 11), done)``; ``index`` is
                     ``(edge_draws, done)``: the key after that many splits
                     and the batch's count within its advance.

A config draws only where a SELECTIVE or a SPOOF role is assigned, so an
all-HONEST config (and one with only crash, eclipse or sybil roles) calls
``fault_draw`` never, and an all-HONEST config is bitwise the
``faults=None`` run. The default (``torch_fault_draw``) is a
``torch.Generator`` on the device; the tests pass the reference's draws.

``faults=None`` in ``GossipNetwork`` runs none of this code.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dag import DagState
from repro_torch.kernels import chunk_transfer as chunk_kernel
from repro_torch.net import bank as bank_lib

ROLE_HONEST = 0
ROLE_CRASH = 1
ROLE_ECLIPSE = 2
ROLE_SELECTIVE = 3
ROLE_SPOOF = 4
ROLE_SYBIL = 5

ROLE_NAMES = ("honest", "crash", "eclipse", "selective", "spoof", "sybil")

# what seeds the default draws apart from the edge draws: the reference's salts
_SALT_EDGES = 7
_SALT_SPOOF = 11

FaultDraw = Callable[[str, object, Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static adversary assignment.

    ``roles``            one ``ROLE_*`` per node (tuple, length N).
    ``crash_start/end``  the window CRASH nodes are dark. The ticks engine
                         evaluates it at the tick's instant ``(tick + 1) *
                         sync_period`` (f32), the events engine at the
                         batch's instant; on the ideal wire (period <= 0)
                         every tick is at t = 0.
    ``eclipse_target``   the node ECLIPSE attackers isolate (required when an
                         ECLIPSE role is assigned).
    ``forward_prob``     SELECTIVE nodes forward each edge with this
                         probability per round.
    ``spoof_rate``       probability a SPOOF node corrupts an admitted chunk.
    ``verify_digests``   the defense switch (see the module docstring).
    ``quarantine_after`` cumulative rejections at which a (receiver, sender)
                         link is cut for good.
    """

    roles: Tuple[int, ...]
    crash_start: float = 0.0
    crash_end: float = float("inf")
    eclipse_target: int = -1
    forward_prob: float = 0.5
    spoof_rate: float = 1.0
    verify_digests: bool = True
    quarantine_after: int = 3


class FaultState(NamedTuple):
    """The defense's carry (bank runs only: bankless faults are stateless
    edge and row rewrites)."""

    rejects: torch.Tensor   # (N, N) i32 digest rejections: receiver i charged sender j
    tainted: torch.Tensor   # (N, S, C) bool corrupted chunks accepted (verify off)


def init_fault_state(n: int, slots: int, chunks: int, device=None) -> FaultState:
    return FaultState(
        rejects=torch.zeros((n, n), dtype=torch.int32, device=device),
        tainted=torch.zeros((n, slots, chunks), dtype=torch.bool, device=device),
    )


def validate_faults(cfg: FaultConfig, n: int, bank: bool) -> None:
    if len(cfg.roles) != n:
        raise ValueError(f"FaultConfig.roles has {len(cfg.roles)} entries for {n} nodes")
    bad = [r for r in cfg.roles if r not in range(len(ROLE_NAMES))]
    if bad:
        raise ValueError(f"unknown fault roles: {bad!r}")
    if ROLE_ECLIPSE in cfg.roles and not 0 <= cfg.eclipse_target < n:
        raise ValueError("ROLE_ECLIPSE assigned but eclipse_target is not a valid node")
    if ROLE_SPOOF in cfg.roles and not bank:
        raise ValueError("ROLE_SPOOF corrupts chunk payloads in flight — it requires "
                         "bank gossip (construct GossipNetwork with bank_cfg)")
    if cfg.quarantine_after < 1:
        raise ValueError("quarantine_after must be >= 1")


class _RoleMasks(NamedTuple):
    """Static per-role masks (numpy: roles never change mid-run)."""

    crash: np.ndarray         # (N,) bool
    eclipse_keep: np.ndarray  # (N, N) bool — edges the eclipse leaves alive
    selective: np.ndarray     # (N,) bool
    spoof: np.ndarray         # (N,) bool
    sybil: np.ndarray         # (N,) bool
    any_crash: bool
    any_selective: bool
    any_spoof: bool
    any_sybil: bool


@functools.lru_cache(maxsize=None)
def _role_masks(cfg: FaultConfig) -> _RoleMasks:
    roles = np.asarray(cfg.roles, np.int32)
    n = roles.shape[0]
    crash = roles == ROLE_CRASH
    selective = roles == ROLE_SELECTIVE
    spoof = roles == ROLE_SPOOF
    sybil = roles == ROLE_SYBIL
    attackers = roles == ROLE_ECLIPSE
    keep = np.ones((n, n), bool)
    if attackers.any():
        # the target keeps only its links to and from the attackers (and its
        # self-loop): everything it learns is relayed through them
        tgt = int(cfg.eclipse_target)
        allowed = attackers | (np.arange(n) == tgt)
        keep[tgt, :] = allowed
        keep[:, tgt] = allowed
    return _RoleMasks(
        crash=crash, eclipse_keep=keep, selective=selective, spoof=spoof, sybil=sybil,
        any_crash=bool(crash.any()), any_selective=bool(selective.any()),
        any_spoof=bool(spoof.any()), any_sybil=bool(sybil.any()),
    )


def torch_fault_draw(seed: int, device) -> FaultDraw:
    """Uniforms in [0, 1) from one ``torch.Generator`` on ``device``, seeded
    apart from the edge draws' generator, consumed in call order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, _SALT_EDGES, _SALT_SPOOF])
                        .generate_state(1, np.uint64)[0] >> np.uint64(1)))

    def draw(stream: str, index, shape) -> torch.Tensor:
        return torch.rand(shape, generator=gen, device=device)

    return draw


def sybil_inflate(dags: DagState, sybil: torch.Tensor) -> DagState:
    """SYBIL nodes (``sybil`` (N,) bool) forge the full approver bitset on
    their own rows.

    Runs on the stacked replicas after each round: every row a sybil node
    published in its own replica claims every node as an approver before
    the next exchange relays it. The exact approver-set union caps the
    damage at N distinct approvers; ``approval_count`` is recounted on every
    row, an int32 sum as the reference's.
    """
    r = dags.publisher.shape[0]
    own = dags.publisher == torch.arange(r, dtype=dags.publisher.dtype,
                                         device=dags.publisher.device)[:, None]
    forge = own & sybil[:, None]
    approvers = dags.approvers | forge[:, :, None]
    return dags._replace(approvers=approvers,
                         approval_count=approvers.sum(dim=-1, dtype=torch.int32))


def quarantined(fstate: FaultState, cfg: FaultConfig) -> torch.Tensor:
    """(N, N) bool — links cut by the rejection counter."""
    return fstate.rejects >= cfg.quarantine_after


class FaultLayer:
    """A ``FaultConfig`` bound to one network: its role masks on the device,
    its draws, and the hooks the round bodies call.

    ``drawn()`` is the network's edge-draw count, read when a hook draws:
    a round's own index is ``drawn() - 1`` once its edge draw is made.
    """

    def __init__(self, cfg: FaultConfig, device, draw: FaultDraw, drawn: Callable[[], int]):
        m = _role_masks(cfg)
        self.cfg, self.masks = cfg, m
        self._draw, self._drawn = draw, drawn

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        # the eclipse's keep mask, None where it keeps every edge
        self._keep = None if m.eclipse_keep.all() else dev(m.eclipse_keep)
        self._crash = dev(m.crash)
        self._selective = dev(m.selective)
        self._spoof = dev(m.spoof)
        self._sybil = dev(m.sybil)
        # the window and the probabilities as f32 values: the reference
        # compares f32 instants and uniforms with them
        self._crash_t0 = float(np.float32(cfg.crash_start))
        self._crash_t1 = float(np.float32(cfg.crash_end))
        self._forward_prob = float(np.float32(cfg.forward_prob))
        self._spoof_rate = float(np.float32(cfg.spoof_rate))

    def edges(self, t: float, edges: torch.Tensor) -> torch.Tensor:
        """The edge-level attacks on a sampled or live mask (``edges[i, j]``:
        receiver i hears sender j) at the f32 instant ``t``: pure
        suppression, so an all-HONEST config returns ``edges`` bitwise. Only
        SELECTIVE draws (stream "edges")."""
        m = self.masks
        keep = self._keep
        if m.any_crash and self._crash_t0 <= t < self._crash_t1:
            dark = self._crash
            live = ~dark[:, None] & ~dark[None, :]
            keep = live if keep is None else keep & live
        if m.any_selective:
            u = self._draw("edges", self._drawn() - 1, tuple(edges.shape))
            fwd = ~self._selective[None, :] | (u < self._forward_prob)
            keep = fwd if keep is None else keep & fwd
        return edges if keep is None else edges & keep

    def inflate(self, dags: DagState) -> DagState:
        """``sybil_inflate`` where a SYBIL role is assigned, else ``dags``."""
        return sybil_inflate(dags, self._sybil) if self.masks.any_sybil else dags

    def service(self, dags: DagState, bstate: bank_lib.BankState, fstate: FaultState,
                digest: torch.Tensor, edges: torch.Tensor, cap_bytes: torch.Tensor,
                chunk_bytes: float, batch: Optional[int] = None):
        """The fault-aware bank service step (``bank.chunk_step``'s
        counterpart).

        ``cap_bytes`` is the budget each edge gains (a tick's cap, or the
        events engine's accrual), ``chunk_bytes`` the wire price of a chunk
        (an f32 value). Spoofed payloads are drawn per admitted transfer,
        on the ticks engine from stream "spoof" at the round's index, on the
        events engine (``batch`` = the batch's count within its advance)
        from "spoof_batch". With ``verify_digests`` the receive path drops
        mismatches (``transfer_verify``), a rejecting link loses its credit
        and the sender is charged; without it the corrupted chunks land and
        ``tainted`` spreads (re-serving a tainted store corrupts downstream
        receivers too). Spent bytes are billed for rejected chunks too.

        Returns ``(bstate, fstate, pending)``; its inputs are left as they
        were.
        """
        cfg = self.cfg
        r = edges.shape[0]
        s, c = bstate.have.shape[1], bstate.have.shape[2]
        m = s * c
        if cfg.verify_digests:
            edges = edges & ~quarantined(fstate, cfg)
        sat = chunk_kernel.chunk_dedup(bstate.have, digest)
        ref = bank_lib.referenced_slots(dags, s)
        need = (ref[:, :, None] & ~sat).reshape(r, m)
        budget = bstate.credit + torch.where(edges, cap_bytes, 0.0)
        take, take_link, spent_chunks, pending = chunk_kernel.transfer_select(
            need, sat.reshape(r, m), edges, bank_lib._afford(budget, chunk_bytes),
            return_links=True)
        # transfers whose bytes will not hash to the announced digest: freshly
        # spoofed by the sender, or re-served from a store that accepted
        # garbage earlier (the verify-off infection); the sender is axis 1
        bad = fstate.tainted.reshape(r, m)[None, :, :]
        if self.masks.any_spoof:
            if batch is None:
                stream, index = "spoof", self._drawn() - 1
            else:
                stream, index = "spoof_batch", (self._drawn(), batch)
            u = self._draw(stream, index, tuple(take_link.shape))
            bad = bad | (self._spoof[None, :, None] & (u < self._spoof_rate))
        bad = take_link & bad
        spent = spent_chunks.float() * chunk_bytes
        keep_credit = torch.where(pending, budget - spent,
                                  torch.where(edges, 0.0, bstate.credit))
        if cfg.verify_digests:
            ok_take, rej = chunk_kernel.transfer_verify(take_link, bad)
            have = bstate.have | ok_take.reshape(r, s, c)
            # rejected bytes still crossed the wire (the attacker's bill); the
            # link's rolled-over budget is dropped as back-off
            credit = torch.where(rej > 0, 0.0, keep_credit)
            fstate = fstate._replace(rejects=fstate.rejects + rej)
        else:
            have = bstate.have | take.reshape(r, s, c)
            credit = keep_credit
            fstate = fstate._replace(tainted=fstate.tainted | bad.any(dim=1).reshape(r, s, c))
        return bank_lib.BankState(have=have, credit=credit, sent=bstate.sent + spent), \
            fstate, pending
