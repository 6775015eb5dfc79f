"""LLaMA2-7B [arXiv:2307.09288] — the paper's own fine-tuning target (LoRA rank 16)."""
from repro_torch.configs.base import LoRAConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b",
        arch_type="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=11008,
        vocab_size=32000,
        rope_theta=10000.0,
        norm_type="rmsnorm",
        mlp_act="silu",
        lora=LoRAConfig(rank=16, alpha=32.0, targets=("q", "v")),
        source="arXiv:2307.09288 (paper Sec. VI-A)",
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
