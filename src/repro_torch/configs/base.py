"""Configs: the model configuration (a copy of the reference's, with its
LoRA, MoE and SSM parts; the MoE and SSM parts only because ModelConfig names
them), the training config and the scheduling configs (the job four-tuple,
the throughput model).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.02


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    state_size: int = 128        # N
    head_dim: int = 64           # P
    num_heads: int = 0           # derived if 0: d_inner // head_dim
    expand: int = 2              # d_inner = expand * d_model
    n_groups: int = 1            # B/C groups (like GQA for SSM)
    conv_width: int = 4
    chunk_size: int = 256        # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def heads(self, d_model: int) -> int:
        return self.num_heads or self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("q", "v")  # subset of {"q","k","v","o","mlp"}
    dropout: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # one of ARCH_TYPES
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0               # 0 -> num_heads (MHA)
    head_dim: int = 0                   # 0 -> d_model // num_heads
    # --- attention details ---
    rope_theta: float = 10000.0
    m_rope: bool = False                # Qwen2-VL multimodal RoPE
    m_rope_sections: Tuple[int, int, int] = (16, 24, 24)  # t,h,w halves of head_dim/2
    qkv_bias: bool = False
    o_bias: bool = False
    sliding_window: Optional[int] = None  # SWA window (tokens); None = full attn
    causal: bool = True                 # False for encoder-only
    # --- norm / mlp ---
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np (OLMo non-parametric)
    norm_eps: float = 1e-5
    mlp_act: str = "silu"               # silu (SwiGLU) | gelu (plain 2-matrix MLP)
    mlp_bias: bool = False
    # --- embeddings ---
    tie_embeddings: bool = False
    # --- family-specific ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): every `hybrid_period` SSM layers, apply the single
    # *shared* attention block. 0 = not hybrid.
    hybrid_period: int = 0
    # encoder-only (audio): no decode path, bidirectional attention
    encoder_only: bool = False
    # modality frontend stub: inputs are precomputed embeddings, not token ids
    embed_inputs: bool = False          # True -> input_specs gives (B,S,d_model) floats
    # --- fine-tuning ---
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    # scan granularity: number of layers grouped per scan step (1 = plain scan)
    dtype: str = "bfloat16"
    # citation for the assigned config
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        assert self.arch_type in ARCH_TYPES, self.arch_type
        if self.num_kv_heads == 0:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.hybrid_period:
            assert self.ssm is not None, "hybrid needs an SSMConfig"
            assert self.num_layers % self.hybrid_period == 0

    # ------------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def is_sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context without a full-seq KV cache?"""
        return (
            self.arch_type in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    # --- parameter counting (used for checkpoint bytes / switching cost) ---
    def param_count(self) -> int:
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.embed_inputs:
            emb = V * d  # output head only; frontend is a stub
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        if self.qkv_bias:
            attn += (h + 2 * kv) * hd
        if self.mlp_act == "silu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        norm = 0 if self.norm_type == "layernorm_np" else 2 * d
        per_layer = 0
        if self.arch_type == "moe":
            assert self.moe is not None
            per_layer = attn + self.moe.num_experts * mlp + d * self.moe.num_experts + 2 * norm
            return emb + L * per_layer + norm
        if self.arch_type == "ssm":
            per_layer = self._ssm_params() + norm
            return emb + L * per_layer + norm
        if self.arch_type == "hybrid":
            n_shared = L // self.hybrid_period
            shared_attn = attn + 2 * norm + mlp  # one shared transformer block
            per_layer = self._ssm_params() + norm
            return emb + L * per_layer + shared_attn + norm
        per_layer = attn + mlp + 2 * norm
        return emb + L * per_layer + norm

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        s, d = self.ssm, self.d_model
        di = s.d_inner(d)
        H = s.heads(d)
        conv_dim = di + 2 * s.n_groups * s.state_size
        in_proj = d * (2 * di + 2 * s.n_groups * s.state_size + H)
        return in_proj + conv_dim * s.conv_width + H * 2 + di + di * d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        assert self.moe is not None
        d, f, L = self.d_model, self.d_ff, self.num_layers
        mlp = 3 * d * f if self.mlp_act == "silu" else 2 * d * f
        dead = (self.moe.num_experts - self.moe.top_k) * mlp * L
        return self.param_count() - dead

    def flops_per_token(self) -> float:
        """Forward-pass matmul FLOPs per token (2*active_params, ignoring attn score term)."""
        return 2.0 * self.active_param_count()

    def lora_param_count(self) -> int:
        r = self.lora.rank
        d, hd = self.d_model, self.head_dim
        h, kv = self.num_heads, self.num_kv_heads
        n = 0
        per = {
            "q": d * r + r * h * hd,
            "k": d * r + r * kv * hd,
            "v": d * r + r * kv * hd,
            "o": h * hd * r + r * d,
        }
        for t in self.lora.targets:
            if t in per:
                n += per[t]
        L = self.num_layers
        if self.arch_type == "hybrid":
            L = self.num_layers // self.hybrid_period  # LoRA on the shared attn block
        if self.arch_type == "ssm":
            # no attention: LoRA applied to in/out projections instead
            assert self.ssm is not None
            di = self.ssm.d_inner(d)
            return self.num_layers * (d * r + r * di + di * r + r * d)
        return L * n

    def reduced(self, **overrides) -> "ModelConfig":
        """A reduced same-family variant for CPU smoke tests."""
        small = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=0,
            head_dim=0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            name=self.name + "-smoke",
            dtype="float32",  # exact CPU numerics for smoke tests
        )
        if self.num_kv_heads < self.num_heads:
            small["num_kv_heads"] = max(1, min(self.num_kv_heads, small["num_heads"] // 2))
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4)
            )
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm,
                state_size=min(self.ssm.state_size, 16),
                head_dim=min(self.ssm.head_dim, 32),
                chunk_size=32,
            )
        if self.hybrid_period:
            small["num_layers"] = 2
            small["hybrid_period"] = 1
        if self.sliding_window is not None:
            small["sliding_window"] = min(self.sliding_window, 64)
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Training / scheduling configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 1024
    global_batch: int = 32
    lr: float = 2e-4
    weight_decay: float = 0.0
    warmup_steps: int = 20
    total_steps: int = 200
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    remat: str = "none"  # none | full | dots: any but none recomputes layers
    # gradient accumulation: microbatches summed in order inside the train
    # step; the elastic trainer holds the global batch fixed while the
    # scheduler varies the instance count (paper Sec. III-B)
    microbatches: int = 1


@dataclass(frozen=True)
class JobConfig:
    """The paper's four-tuple {L, d, N^min, N^max} plus value-function params.

    Fields may also hold (B,) tensors: the batched window solver builds one
    per-row JobConfig over a whole lane batch."""

    workload: float = 80.0          # L
    deadline: int = 10              # d (slots)
    n_min: int = 1
    n_max: int = 12
    value: float = 40.0             # v
    gamma: float = 2.0              # hard deadline = gamma * d
    on_demand_price: float = 1.0    # p^o per instance-slot


@dataclass(frozen=True)
class ThroughputConfig:
    alpha: float = 1.0              # H(n) = alpha*n + beta (n>0)
    beta: float = 0.0
    mu1: float = 0.9                # scale-up effective fraction
    mu2: float = 0.95               # scale-down effective fraction
