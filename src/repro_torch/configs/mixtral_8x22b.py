"""Mixtral-8x22B [arXiv:2401.04088] — MoE, 8 experts top-2, sliding-window attention."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        arch_type="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        rope_theta=1_000_000.0,
        sliding_window=4096,
        norm_type="rmsnorm",
        mlp_act="silu",
        moe=MoEConfig(num_experts=8, top_k=2),
        source="arXiv:2401.04088",
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
