"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01 family] — dense GQA, no biases."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        arch_type="dense",
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        rope_theta=75_000_000.0,
        norm_type="layernorm",
        mlp_act="silu",
        tie_embeddings=True,
        source="hf:CohereForAI/c4ai-command-r-v01",
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
