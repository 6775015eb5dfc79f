"""Granite-20B (code) [arXiv:2405.04324] — llama-style dense with MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        arch_type="dense",
        num_layers=52,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,   # multi-query attention
        d_ff=24576,
        vocab_size=49152,
        rope_theta=10000.0,
        norm_type="rmsnorm",
        mlp_act="silu",
        source="arXiv:2405.04324",
    )


def smoke_config() -> ModelConfig:
    return config().reduced(num_kv_heads=1)
