"""OLMo-1B [arXiv:2402.00838] — dense, non-parametric LayerNorm, no biases, tied embeddings."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        arch_type="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        rope_theta=10000.0,
        norm_type="layernorm_np",  # non-parametric LN (no scale/bias)
        mlp_act="silu",
        tie_embeddings=True,
        source="arXiv:2402.00838",
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
