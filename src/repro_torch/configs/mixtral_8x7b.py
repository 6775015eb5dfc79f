"""Mixtral-8x7B [arXiv:2401.04088] — MoE, 8 experts top-2, sliding-window attention."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        arch_type="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        rope_theta=1_000_000.0,
        sliding_window=4096,
        norm_type="rmsnorm",
        mlp_act="silu",
        moe=MoEConfig(num_experts=8, top_k=2),
        source="arXiv:2401.04088",
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
