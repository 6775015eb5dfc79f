"""Zamba2-2.7B [arXiv:2411.15242] — hybrid: Mamba2 backbone + shared attention block.

54 Mamba2 layers; one *shared* (weight-tied) transformer block is applied every
``hybrid_period`` layers (9 applications). We scan over 9 super-blocks of
6 Mamba2 layers each, with the shared block's params closed over (not scanned).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        arch_type="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        rope_theta=10000.0,
        norm_type="rmsnorm",
        mlp_act="silu",
        ssm=SSMConfig(
            state_size=64,
            head_dim=64,
            expand=2,          # d_inner = 5120 -> 80 SSD heads
            n_groups=1,
            conv_width=4,
            chunk_size=256,
        ),
        hybrid_period=6,
        source="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
