"""Serving launcher: continuous-batching-lite over the prefill/decode paths.

    python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8 --max-new 16
    python -m repro_torch.launch.serve --device cpu

The port of ``repro.launch.serve``. A fixed-size slot pool holds per-request
decode state; arriving requests are prefilled into free slots, all active
slots decode in lockstep (one ``decode_step`` per tick, through the decode
attention kernel on the card), finished requests free their slot.

As in the reference, the dense model's slots share one cache position:
``_write_slot`` copies a prefilled request's k and v into its slot but
leaves the server's ``length`` as it is (the reference skips every cache
leaf of fewer than two dimensions, and its stacked length is one), so the
first tick decodes at position 0, whatever the prompt's length. An RWKV
cache (``RWKVState``: three stacked ``(L, B, ...)`` leaves, no length) is
copied leaf by leaf, so every slot carries its own request's state:

    python -m repro_torch.launch.serve --arch rwkv6-7b --device cpu
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.models import build_model
from repro_torch.models.rwkv import RWKVState


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class SlotServer:
    """Fixed B decode slots; per-slot KV caches live in one batched cache."""

    def __init__(self, cfg, params, slots: int, max_len: int):
        self.cfg, self.params = cfg, params
        self.model = build_model(cfg)
        self.device = params["embed"].device
        self.slots = slots
        self.max_len = max_len
        self.cache = self.model.init_cache(slots, max_len, device=self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.tokens = torch.zeros((slots, 1), dtype=torch.long, device=self.device)

    def _write_slot(self, slot: int, cache_one, last_tok: int):
        """Copy a freshly prefilled single-request cache into slot ``slot``
        (in place; a dense cache's shared length stays the server's)."""
        if isinstance(self.cache, RWKVState):
            for dst, src in zip(self.cache, cache_one):
                dst[:, slot] = src[:, 0]
        else:
            dst, src = self.cache["stack"], cache_one["stack"]
            dst.k[:, slot] = src.k[:, 0]
            dst.v[:, slot] = src.v[:, 0]
        self.tokens[slot, 0] = last_tok

    def admit(self, req: Request) -> bool:
        for s in range(self.slots):
            if self.active[s] is None:
                logits, cache_one = self.model.prefill(self.params, req.prompt[None, :],
                                                       cache_len=self.max_len)
                tok = int(torch.argmax(logits[0, -1]))
                req.out.append(tok)
                self._write_slot(s, cache_one, tok)
                self.active[s] = req
                return True
        return False

    def tick(self):
        """One lockstep decode over all slots (inactive slots decode garbage
        that is simply ignored — the production pattern)."""
        if not any(self.active):
            return
        logits, self.cache = self.model.decode_step(self.params, self.tokens, self.cache)
        nxt = torch.argmax(logits[:, 0, :], dim=-1)
        self.tokens = nxt[:, None]
        nxt = nxt.tolist()                # the tick's one read back
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(nxt[s])
            if len(req.out) >= req.max_new:
                req.done = True
                self.active[s] = None

    @property
    def length(self) -> Optional[int]:
        """The cache position every slot decodes at next; None for a state
        cache (RWKV), which has no position."""
        if isinstance(self.cache, RWKVState):
            return None
        return self.cache["stack"].length


def serve(server: SlotServer, queue: List[Request], max_ticks: int = 10000) -> int:
    """Admit and tick until every request is done; returns the tick count."""
    pending = list(queue)
    ticks = 0
    while pending or any(server.active):
        while pending and server.admit(pending[0]):
            pending.pop(0)
        server.tick()
        ticks += 1
        if ticks > max_ticks:
            break
    return ticks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args()

    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.max_new + cfg.frontend_tokens + 2

    server = SlotServer(cfg, params, args.slots, max_len)
    queue = [
        Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    ticks = serve(server, queue)
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in queue)
    print(f"arch={cfg.name} device={server.device} served {len(queue)} requests / "
          f"{total_tokens} tokens in {dt:.2f}s over {ticks} ticks ({total_tokens/dt:.1f} tok/s)")
    for r in queue[:3]:
        print(f"  req {r.rid}: {r.out[: args.max_new]}")


if __name__ == "__main__":
    main()
