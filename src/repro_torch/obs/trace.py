"""Fixed-capacity event trace ring for the gossip overlay (port of ``repro.obs.trace``).

A trace is stacked columns ``(t, kind, src, dst, arg)`` on the device plus a
write cursor and an overflow counter, both () i32 tensors on the device, so
an append never waits for the host. Device-side appends happen per merge
round or event batch (every live delivery edge and every link that moved
payload bytes becomes one record); host-side spans (PUBLISH / COMMIT, which
the FL loop knows, and PARTITION transitions) are buffered on the host and
merged at drain time.

Overflow policy: the ring keeps the FIRST ``capacity`` records and counts
the rest in ``dropped``; it never wraps. Each column holds one slot more
than the capacity: appends past the capacity (and masked-out edges) all
write that last slot, which no reader sees, so dropping needs no host
decision. Appends write the columns in place.

Record kinds (``arg`` per kind):

  ``KIND_DELIVER``    delivery src -> dst survived loss and partition;
                      arg = rows the receiver merged that round;
  ``KIND_DRAIN``      payload bytes moved src -> dst; arg = bytes;
  ``KIND_PUBLISH``    node began an iteration (host record at t0);
                      arg = its duration (seconds);
  ``KIND_COMMIT``     node landed its transaction (host record at t1);
                      arg = global sequence number;
  ``KIND_PARTITION``  partition transition (host record); arg = 1.0 begin /
                      0.0 heal, src = dst = -1;
  ``KIND_REJECT``     digest rejections src -> dst this round (fault
                      injection with the bank); arg = rejections;
  ``KIND_INFER``      an inference batch admitted (serving, not ported yet).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

KIND_DELIVER = 0
KIND_DRAIN = 1
KIND_PUBLISH = 2
KIND_COMMIT = 3
KIND_PARTITION = 4
KIND_REJECT = 5
KIND_INFER = 6

KIND_NAMES = {
    KIND_DELIVER: "deliver",
    KIND_DRAIN: "drain",
    KIND_PUBLISH: "publish",
    KIND_COMMIT: "commit",
    KIND_PARTITION: "partition",
    KIND_REJECT: "reject",
    KIND_INFER: "infer",
}


class TraceRing(NamedTuple):
    """Stacked-column trace ring; each column has ``capacity + 1`` slots."""

    t: torch.Tensor        # (C+1,) f32 record instant
    kind: torch.Tensor     # (C+1,) i32 KIND_*
    src: torch.Tensor      # (C+1,) i32 sender / acting node (-1 = overlay)
    dst: torch.Tensor      # (C+1,) i32 receiver / acting node (-1 = overlay)
    arg: torch.Tensor      # (C+1,) f32 kind-specific payload
    cursor: torch.Tensor   # ()   i32 records attempted (monotone)
    dropped: torch.Tensor  # ()   i32 records past capacity (dropped)

    @property
    def capacity(self) -> int:
        return int(self.t.shape[0]) - 1


def init_trace(capacity: int, device="cpu") -> TraceRing:
    c = int(capacity) + 1

    def full(value, dtype):
        return torch.full((c,), value, dtype=dtype, device=device)

    return TraceRing(
        t=full(0.0, torch.float32), kind=full(-1, torch.int32), src=full(-1, torch.int32),
        dst=full(-1, torch.int32), arg=full(0.0, torch.float32),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def _on_device(value, shape, device) -> torch.Tensor:
    """``value`` (a tensor, or a number filled on the device: a copy of a host
    scalar would wait for the stream) as f32, broadcast to ``shape``."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32).broadcast_to(shape)
    return torch.full(shape, float(value), dtype=torch.float32, device=device)


def append_edges(ring: TraceRing, t, kind: int, mask: torch.Tensor, arg) -> TraceRing:
    """Append one record per True edge of ``mask``, in place; returns ``ring``.

    ``mask`` is (N, N) bool in the overlay's [receiver, sender] layout;
    ``arg`` (a tensor or a number) broadcasts against it; ``t`` is an f32
    instant (a () tensor or a number). Active edges take consecutive slots
    in flat index order (a prefix sum assigns them); edges past capacity go
    to the spare slot and count in ``dropped``.
    """
    n = mask.shape[0]
    cap = ring.capacity
    dev = mask.device
    flat = mask.reshape(-1)
    fi = flat.to(torch.int32)
    pos = torch.cumsum(fi, 0, dtype=torch.int32) - fi
    idx = ring.cursor + pos
    slot = torch.where(flat & (idx < cap), idx, cap).long()
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ring.t.index_put_((slot,), _on_device(t, (n * n,), dev))
    ring.kind.index_put_((slot,), torch.full((n * n,), int(kind), dtype=torch.int32, device=dev))
    ring.src.index_put_((slot,), ids.repeat(n))
    ring.dst.index_put_((slot,), ids.repeat_interleave(n))
    ring.arg.index_put_((slot,), _on_device(arg, mask.shape, dev).reshape(-1))
    ring.dropped.add_((fi * (idx >= cap).to(torch.int32)).sum(dtype=torch.int32))
    ring.cursor.add_(fi.sum(dtype=torch.int32))
    return ring


def drain(ring: TraceRing, host_events=()) -> dict:
    """Pull the ring to the host and merge buffered host-side records.

    ``host_events`` is an iterable of ``(t, kind, src, dst, arg)`` tuples.
    Returns ``{"t", "kind", "src", "dst", "arg"}`` numpy arrays sorted by
    ``(t, kind)`` (a stable sort: the event engine's tie order); the caller
    reports ``ring.dropped``.
    """
    n = int(min(int(ring.cursor), ring.capacity))
    t = ring.t[:n].cpu().numpy()
    kind = ring.kind[:n].cpu().numpy()
    src = ring.src[:n].cpu().numpy()
    dst = ring.dst[:n].cpu().numpy()
    arg = ring.arg[:n].cpu().numpy()
    if host_events:
        h = np.asarray(list(host_events), np.float64).reshape(-1, 5)
        t = np.concatenate([t.astype(np.float64), h[:, 0]])
        kind = np.concatenate([kind, h[:, 1].astype(np.int32)])
        src = np.concatenate([src, h[:, 2].astype(np.int32)])
        dst = np.concatenate([dst, h[:, 3].astype(np.int32)])
        arg = np.concatenate([arg.astype(np.float64), h[:, 4]])
    order = np.lexsort((kind, t))
    return {
        "t": np.asarray(t, np.float64)[order],
        "kind": kind[order],
        "src": src[order],
        "dst": dst[order],
        "arg": np.asarray(arg, np.float64)[order],
    }
