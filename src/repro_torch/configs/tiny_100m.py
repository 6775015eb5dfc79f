"""~100M-param dense model for the end-to-end CPU example."""
from repro_torch.configs.base import LoRAConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tiny-100m",
        arch_type="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=32000,
        rope_theta=10000.0,
        norm_type="rmsnorm",
        mlp_act="silu",
        tie_embeddings=True,
        lora=LoRAConfig(rank=16, alpha=32.0, targets=("q", "v")),
        source="end-to-end CPU example",
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
