"""Config dataclasses of the port: the model zoo and the DAG-FL deployment.

The port's copy of ``repro.configs.base``: ``ModelConfig`` with its derived
sizes and ``reduced()`` (the CPU smoke-test variant: 2 layers, d_model <=
512, <= 4 experts), the model-zoo input shapes ``ShapeSpec``/``SHAPES``, and
``DagFLConfig``, and the training hyperparameters ``TrainConfig`` and
``RunConfig``. Every class is a frozen dataclass, so configs hash and
compare.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Sequence-mixing families understood by the model zoo.
FAMILIES = ("dense", "moe", "rwkv", "hybrid", "audio", "vlm")

# Attention kinds. "none" => attention-free (rwkv).
ATTENTION_KINDS = ("full", "sliding_window", "mla", "none")

NORM_KINDS = ("rmsnorm", "layernorm", "nonparam_layernorm")
ACT_KINDS = ("swiglu", "geglu", "gelu")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    num_heads: int = 0               # 0 for attention-free archs
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 => d_model // num_heads
    attention: str = "full"
    window_size: int = 8192          # used when attention == "sliding_window"
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # --- MLA (DeepSeek-V2 style) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0              # 0 => head_dim

    # --- norms / MLP ---
    norm: str = "rmsnorm"
    act: str = "swiglu"

    # --- MoE ---
    num_experts: int = 0             # routed experts; 0 => dense MLP
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # 0 => d_ff (per-expert hidden)
    router_aux_loss: float = 0.01
    first_dense_layers: int = 0      # DeepSeek keeps layer 0 dense
    moe_impl: str = "sorted"         # "sorted" (prod) | "dense" (oracle)

    # --- SSM / RWKV ---
    ssm_state: int = 0               # Mamba2 state size per head
    ssm_heads: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64

    # --- hybrid (Zamba2): one SHARED attention block applied every k layers
    shared_attn_every: int = 0       # 0 => no shared attention blocks

    # --- modality frontend stubs (audio / vlm) ---
    frontend_tokens: int = 0         # prepended embedding positions from stub
    frontend_dim: int = 0            # raw embedding dim from the (stubbed) encoder

    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    citation: str = ""

    # -- derived ----------------------------------------------------------
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim or self.resolved_head_dim()

    def uses_attention(self) -> bool:
        return self.attention != "none"

    def is_moe(self) -> bool:
        return self.num_experts > 0

    def sub_quadratic(self) -> bool:
        """True when a 500k-token decode is admissible (bounded state)."""
        return self.attention in ("none", "sliding_window") or self.family in (
            "rwkv",
            "hybrid",
        )

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4) if self.num_heads else 0
        num_kv = min(self.num_kv_heads, num_heads) if self.num_kv_heads else 0
        if num_kv and self.num_kv_heads == 1:
            num_kv = 1  # preserve MQA structure
        head_dim = 64 if self.resolved_head_dim() else 0
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            d_ff=min(self.d_ff, 512),
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            rope_head_dim=min(self.rope_head_dim, 32) if self.kv_lora_rank else self.rope_head_dim,
            v_head_dim=64 if self.v_head_dim else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            shared_attn_every=min(self.shared_attn_every, 2) if self.shared_attn_every else 0,
            window_size=min(self.window_size, 64),
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Closed-form parameter count (total, incl. all experts)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d
        hd = self.resolved_head_dim()
        vhd = self.resolved_v_head_dim()
        per_layer = 0
        if self.uses_attention() and self.family not in ("rwkv",):
            if self.attention == "mla":
                r_kv, r_q = self.kv_lora_rank, (self.q_lora_rank or self.d_model)
                per_attn = (
                    d * self.q_lora_rank if self.q_lora_rank else 0
                ) + r_q * self.num_heads * (hd + self.rope_head_dim)
                per_attn += d * (r_kv + self.rope_head_dim)
                per_attn += r_kv * self.num_kv_heads * (hd + vhd)
                per_attn += self.num_heads * vhd * d
            else:
                per_attn = d * self.num_heads * hd
                per_attn += 2 * d * self.num_kv_heads * hd
                per_attn += self.num_heads * hd * d
            if self.shared_attn_every:
                # one shared block, counted once below
                pass
            else:
                per_layer += per_attn
        if self.family == "rwkv":
            # time-mix (r,k,v,g,o) + decay + channel-mix approx
            per_layer += 5 * d * d + 2 * d * self.d_ff + d * self.d_ff
        elif self.family == "hybrid":
            # Zamba2-style: Mamba2 mixer only per layer; the MLP lives in the
            # single SHARED attention block (counted once below).
            din = self.ssm_expand * d
            per_layer += d * (2 * din + 2 * self.ssm_heads * self.ssm_state) + din * d
        else:
            n_gate = 2 if self.act in ("swiglu", "geglu") else 1
            if self.is_moe():
                eff = self.moe_d_ff or self.d_ff
                moe = self.num_experts * (n_gate + 1) * d * eff
                moe += self.num_shared_experts * (n_gate + 1) * d * eff
                moe += d * self.num_experts  # router
                per_layer += moe
            else:
                per_layer += (n_gate + 1) * d * self.d_ff
        total += L * per_layer
        if self.shared_attn_every and self.num_heads:
            shared = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
            shared += self.num_heads * hd * d
            n_gate = 2 if self.act in ("swiglu", "geglu") else 1
            shared += (n_gate + 1) * d * self.d_ff  # shared block's MLP
            total += shared
        return total

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: only routed top-k)."""
        if not self.is_moe():
            return self.param_count()
        dense_like = replace(
            self,
            num_experts=self.experts_per_token,
            num_shared_experts=self.num_shared_experts,
        )
        return dense_like.param_count()


# ---------------------------------------------------------------------------
# Input shapes (assignment block)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# DAG-FL deployment configuration (paper Table I + Algorithm params)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DagFLConfig:
    """Parameters of Algorithms 1 & 2 and the Table-I platform constants."""

    num_nodes: int = 100
    alpha: int = 5                  # tips sampled & validated per iteration
    k: int = 2                      # tips aggregated/approved (k < alpha)
    tau_max: float = 20.0           # staleness threshold [s]
    beta: int = 1                   # local epochs per iteration
    minibatch: int = 100
    target_accuracy: float = 0.97   # ACC_0 of Algorithm 1
    isolation_m: int = 0            # <= m approvals => isolated transaction
    capacity: int = 512             # ledger slots (struct-of-arrays)

    # Table-I platform constants (used by the latency model / simulator)
    tx_size_bits: float = 7e6 * 8            # phi   (CNN task default, 7 MB)
    minibatch_size_bits: float = 0.3e6 * 8   # phi_0
    valset_size_bits: float = 0.3e6 * 8      # phi_1
    train_density: float = 500.0             # eta_0 [cycles/bit]
    validate_density: float = 160.0          # eta_1 [cycles/bit]
    cpu_freq_range: Tuple[float, float] = (1e9, 2e9)  # f [Hz]
    bandwidth: float = 100e6                 # B [bit/s]
    arrival_rate: float = 1.0                # lambda [iterations/s]

    def __post_init__(self):
        if not self.k < self.alpha:
            raise ValueError("paper requires k < alpha")

    def expected_tips(self, h: Optional[float] = None) -> float:
        """Eq. (4): L0 = k*lambda*h / (k-1)."""
        if h is None:
            h = self.iteration_delay()
        return self.k * self.arrival_rate * h / (self.k - 1)

    def iteration_delay(self, f: Optional[float] = None) -> float:
        """Eqs. (5)-(7): h = d0 + d1 at mean CPU frequency."""
        if f is None:
            f = 0.5 * (self.cpu_freq_range[0] + self.cpu_freq_range[1])
        d0 = self.train_density * self.minibatch_size_bits * self.beta / f
        d1 = self.validate_density * self.valset_size_bits * self.alpha / f
        return d0 + d1


# ---------------------------------------------------------------------------
# Training / serving hyperparams
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 0.002
    momentum: float = 0.9
    optimizer: str = "sgd"          # "sgd" | "momentum" | "adam"
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    remat: bool = True
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeSpec
    train: TrainConfig = field(default_factory=TrainConfig)
    dagfl: DagFLConfig = field(default_factory=DagFLConfig)
    fl_mode: str = "node"           # "node" (data-axis FL) | "pod" | "off"
