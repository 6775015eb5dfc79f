"""Mamba2-370m [arXiv:2405.21060] — attention-free SSM with SSD (state-space duality)."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        arch_type="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,          # attention-free
        num_kv_heads=0,
        head_dim=1,           # unused
        d_ff=0,               # no MLP; Mamba2 block is the mixer
        vocab_size=50280,
        norm_type="rmsnorm",
        ssm=SSMConfig(
            state_size=128,
            head_dim=64,
            expand=2,         # d_inner = 2048 -> 32 SSD heads
            n_groups=1,
            conv_width=4,
            chunk_size=256,
        ),
        tie_embeddings=True,
        source="arXiv:2405.21060",
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
