"""The model zoo's decoder-only models on PyTorch: the dense transformer
and RWKV6.

The port of ``repro.models.transformer`` for two families. Layer parameters
are stacked ``(L, ...)`` tensors, walked by a Python loop (the reference
scans them).

- dense (GQA/MQA attention, full or sliding-window, QK-norm, QKV bias;
  rmsnorm, layernorm or OLMo's non-parametric layernorm; swiglu, geglu or
  gelu MLP; tied or untied head). Every attention layer goes through the
  hand-written kernels of ``kernels/flash_attention.py``: ``forward`` and
  ``prefill`` through ``flash_attention``, ``decode_step`` through
  ``decode_attention`` (one launch each a layer on the card). Caches are
  ``{"prefix": [], "stack": KVCache(k, v, length)}`` with k and v ``(L, B,
  S, KV, hd)`` written in place by ``decode_step`` and ``length`` a host int
  (the reference stacks one length a layer, all equal).
- rwkv (``models/rwkv.py``): ``embed_norm``, then the blocks. ``forward``
  and ``prefill`` of a length that is a multiple of 32 run every layer's
  WKV through the hand-written kernel of ``kernels/wkv.py`` (one launch a
  layer on the card); ``decode_step`` and other lengths take the plain
  sequential scan. The cache is a stacked ``RWKVState`` (tm_shift and
  cm_shift ``(L, B, d)`` in the model's dtype, wkv ``(L, B, H, hd, hd)``
  f32), with no length; ``decode_step`` writes it in place.

Training (dense only): ``loss`` (next-token cross entropy, the last
position dropped, plus ``router_aux_loss`` times the aux loss) and
``train_step`` (autograd's gradient, then ``optim``'s update). While
autograd records, ``forward`` runs each layer under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
scanned layer) on its own unbound parameter views, and every attention
layer through ``flash_attention_train`` (the prefill kernel forward, its
recompute, and the backward kernel); the embedding's gradient sums repeated
tokens in a fixed order (``layers.embed_lookup``), so a step repeats bit for
bit on either device. RWKV's ``loss`` and ``train_step``
raise ``NotImplementedError`` naming their ROADMAP item (a WKV backward
kernel); the other families raise it when built.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    embed_lookup,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
    xla_mean,
)
from repro_torch.optim.optimizers import make_optimizer, tree_leaves, value_and_grad

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def unported_reason(cfg: ModelConfig):
    """Why the port cannot build ``cfg`` yet (its ROADMAP item), or None."""
    if cfg.family == "rwkv":
        return None
    if cfg.family == "hybrid":
        return "the hybrid family (Mamba2 + shared attention) waits for ROADMAP A.13, part 4"
    if cfg.is_moe():
        return "the MoE family (with moe_shard_map) waits for ROADMAP A.13, part 4"
    if cfg.attention == "mla":
        return "MLA attention waits for ROADMAP A.13, part 4"
    if cfg.frontend_tokens or cfg.family in ("audio", "vlm"):
        return "audio and vision frontends wait for ROADMAP A.13, part 4"
    if cfg.attention not in ("full", "sliding_window"):
        return f"attention {cfg.attention!r} is not ported"
    return None


def train_unported_reason(cfg: ModelConfig):
    """Why the port cannot train ``cfg`` yet (its ROADMAP item), or None."""
    reason = unported_reason(cfg)
    if reason is None and cfg.family == "rwkv":
        return "RWKV training needs a backward kernel of the WKV: ROADMAP A.13, part 3"
    return reason


def _tf_block_apply(cfg: ModelConfig, p: dict, x, positions, mode: str, cache, cache_len: int):
    h = norm_apply(cfg.norm, p["ln1"], x)
    if mode == "decode":
        a, new_cache = attn_lib.attn_decode_step(cfg, p["attn"], h, cache)
    else:
        a, new_cache = attn_lib.attn_forward(cfg, p["attn"], h, positions,
                                             return_cache=(mode == "prefill"),
                                             cache_len=cache_len)
    x = x + a
    h = norm_apply(cfg.norm, p["ln2"], x)
    return x + mlp_apply(cfg, p["mlp"], h), new_cache


def _layer(tree, i: int):
    """Layer ``i`` of stacked ``(L, ...)`` parameters: views, no copies."""
    if isinstance(tree, dict):
        return {name: _layer(sub, i) for name, sub in tree.items()}
    return tree[i]


def _unbind_layers(tree, layers: int) -> list:
    """Stacked ``(L, ...)`` parameters as L per-layer trees of ``unbind``
    views: autograd then stacks the L gradients once, where indexing
    (``_layer``) would add L full-size zero-padded gradients."""
    if isinstance(tree, dict):
        subs = {name: _unbind_layers(sub, layers) for name, sub in tree.items()}
        return [{name: sub[i] for name, sub in subs.items()} for i in range(layers)]
    return tree.unbind(0)


def _train_block(cfg: ModelConfig, p: dict, x, positions):
    return _tf_block_apply(cfg, p, x, positions, "train", None, 0)[0]


def _mean_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy, the mean XLA's (``xla_mean``)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return xla_mean(nll)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        reason = unported_reason(self.cfg)
        if reason:
            raise NotImplementedError(f"{self.cfg.name}: {reason}")

    @property
    def dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.cfg.dtype]

    # ---------------- init ------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Synthetic parameters, drawn on ``device`` from a generator seeded
        with ``seed``; ``device="meta"`` gives their shapes alone."""
        cfg, dtype = self.cfg, self.dtype
        dev = resolve_device(device)
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
        L = cfg.num_layers
        params: Dict[str, Any] = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, dev),
            "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, dev)
        if cfg.family == "rwkv":
            params["layers"] = rwkv_lib.rwkv_block_init(gen, cfg, dtype, dev, L)
            params["embed_norm"] = norm_init("layernorm", cfg.d_model, dtype, dev)
            return params
        params["layers"] = {
            "ln1": norm_init(cfg.norm, cfg.d_model, dtype, dev, L),
            "ln2": norm_init(cfg.norm, cfg.d_model, dtype, dev, L),
            "attn": attn_lib.attn_init(gen, cfg, dtype, dev, L),
            "mlp": mlp_init(gen, cfg, dtype, dev, L),
        }
        return params

    # ---------------- embeddings / head -----------------------------------
    def _embed(self, params, tokens):
        return embed_lookup(params["embed"], tokens)

    def _head(self, params, x):
        x = norm_apply(self.cfg.norm, params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["lm_head"]

    # ---------------- the stack -------------------------------------------
    def _run_layers(self, params, x, positions, mode: str, cache, cache_len: int):
        if self.cfg.family == "rwkv":
            return self._run_rwkv(params, x, mode, cache)
        return self._run_tf(params, x, positions, mode, cache, cache_len)

    def _run_tf(self, params, x, positions, mode, cache, cache_len):
        """Returns (x, new cache or None, aux loss 0)."""
        layers = params["layers"]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if mode == "train" and torch.is_grad_enabled() and (
                x.requires_grad or any(t.requires_grad for t in tree_leaves(layers))):
            for p in _unbind_layers(layers, self.cfg.num_layers):
                x = checkpoint(_train_block, self.cfg, p, x, positions, use_reentrant=False,
                               preserve_rng_state=False)
            return x, None, aux
        caches = []
        for i in range(self.cfg.num_layers):
            lc = None
            if mode == "decode":
                stack = cache["stack"]
                lc = KVCache(stack.k[i], stack.v[i], stack.length)
            x, nc = _tf_block_apply(self.cfg, _layer(layers, i), x, positions, mode, lc,
                                    cache_len)
            caches.append(nc)
        new_cache = None
        if mode == "decode":
            stack = cache["stack"]
            new_cache = {"prefix": [], "stack": KVCache(stack.k, stack.v, stack.length + 1)}
        elif mode == "prefill":
            new_cache = {"prefix": [], "stack": KVCache(
                torch.stack([c.k for c in caches]), torch.stack([c.v for c in caches]),
                caches[0].length)}
        return x, new_cache, aux

    def _run_rwkv(self, params, x, mode, states):
        """Returns (x, new cache or None, aux loss 0). In decode ``states``
        is the stacked cache, written in place (the WKV state by the scan
        itself, the two shift rows by a copy); otherwise every layer starts
        from zeros."""
        cfg = self.cfg
        x = norm_apply("layernorm", params["embed_norm"], x)
        if mode != "decode":
            zero = rwkv_lib.rwkv_empty_state(cfg, x.shape[0], self.dtype, x.device)
        new_states = []
        for i in range(cfg.num_layers):
            st = rwkv_lib.RWKVState(*(leaf[i] for leaf in states)) if mode == "decode" else zero
            x, new = rwkv_lib.rwkv_block_apply(cfg, _layer(params["layers"], i), x, st,
                                               wkv_out=st.wkv if mode == "decode" else None)
            if mode == "decode":
                st.tm_shift.copy_(new.tm_shift)
                st.cm_shift.copy_(new.cm_shift)
            elif mode == "prefill":
                new_states.append(new)
        new_cache = None
        if mode == "decode":
            new_cache = states
        elif mode == "prefill":
            new_cache = rwkv_lib.RWKVState(*(torch.stack(leaves) for leaves in zip(*new_states)))
        return x, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)

    # ---------------- public API -------------------------------------------
    def _tokens(self, params, tokens) -> torch.Tensor:
        device = params["embed"].device
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=device)

    def forward(self, params, tokens, frontend=None):
        """Full-sequence logits (train path). Returns (logits, aux_loss)."""
        tokens = self._tokens(params, tokens)
        x = self._embed(params, tokens)
        B, S = tokens.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, _, aux = self._run_layers(params, x, positions, "train", None, 0)
        return self._head(params, x), aux

    def prefill(self, params, tokens, frontend=None, cache_len: int = 0):
        """Build the serving cache; returns (last-position logits, cache)."""
        tokens = self._tokens(params, tokens)
        x = self._embed(params, tokens)
        B, S = tokens.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, cache, _ = self._run_layers(params, x, positions, "prefill", None, cache_len or S)
        return self._head(params, x[:, -1:, :]), cache

    def decode_step(self, params, token, cache):
        """token: (B, 1) ints. Returns (logits (B,1,V), cache), the cache
        written in place."""
        x = self._embed(params, self._tokens(params, token))
        x, new_cache, _ = self._run_layers(params, x, None, "decode", cache, 0)
        return self._head(params, x), new_cache

    def init_cache(self, batch: int, max_len: int, length: int = 0, device="cuda"):
        """Empty cache for decode; ``length`` tokens considered present. For
        rwkv the stacked zero state, whatever ``max_len`` and ``length``."""
        dev = resolve_device(device)
        if self.cfg.family == "rwkv":
            return rwkv_lib.rwkv_empty_state(self.cfg, batch, self.dtype, dev,
                                             layers=self.cfg.num_layers)
        stack = attn_lib.empty_cache(self.cfg, batch, max_len, self.dtype, dev, length,
                                     layers=self.cfg.num_layers)
        return {"prefix": [], "stack": stack}

    # ---------------- training --------------------------------------------
    def loss(self, params, batch):
        """(total, {"xent", "aux"}) of ``batch`` ({"tokens", "labels"}, (B, S)
        each): position t's logits predict label t + 1."""
        reason = train_unported_reason(self.cfg)
        if reason:
            raise NotImplementedError(f"Model.loss of {self.cfg.name}: {reason}")
        logits, aux = self.forward(params, batch["tokens"])
        labels = self._tokens(params, batch["labels"])
        xent = _mean_xent(logits[:, :-1, :], labels[:, 1:])
        total = xent + self.cfg.router_aux_loss * aux
        return total, {"xent": xent, "aux": aux}

    def train_step(self, train_cfg, params, opt_state, batch, lr):
        """One step: the loss and its gradient by autograd, then the
        optimiser's update. Returns (params, opt_state, metrics with
        ``loss``); ``params`` is not modified."""
        reason = train_unported_reason(self.cfg)
        if reason:
            raise NotImplementedError(f"Model.train_step of {self.cfg.name}: {reason}")
        _, update = make_optimizer(train_cfg)
        (total, metrics), grads = value_and_grad(self.loss, params, batch, has_aux=True)
        params, opt_state = update(grads, opt_state, params, lr)
        metrics = {name: value.detach() for name, value in metrics.items()}
        return params, opt_state, dict(metrics, loss=total.detach())


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def params_from_jax(cfg: ModelConfig, params, device="cuda") -> Dict[str, Any]:
    """The reference's parameters (nested dicts of arrays, ``layers``
    stacked ``(L, ...)``, as ``repro.models.transformer.Model.init`` gives
    them) as the port's tensors on ``device``, in the config's dtype. Each
    leaf converts whatever its leading axes, so the reference's node-stacked
    tree (``jax.vmap(model.init)(keys)``, leaves ``(N, ...)``) gives the
    port's node-stacked tensors (``sharding.fl_step``'s layout)."""
    dev = resolve_device(device)
    dtype = TORCH_DTYPES[cfg.dtype]

    def convert(tree):
        if isinstance(tree, dict):
            return {name: convert(sub) for name, sub in tree.items()}
        arr = np.asarray(tree, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=dtype)

    return {name: convert(sub) for name, sub in params.items() if name != "prefix"}
