"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family scaled] — dense GQA with QKV bias."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        arch_type="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=49152,
        vocab_size=152064,
        rope_theta=1_000_000.0,
        qkv_bias=True,
        norm_type="rmsnorm",
        mlp_act="silu",
        source="hf:Qwen/Qwen1.5-0.5B",
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
