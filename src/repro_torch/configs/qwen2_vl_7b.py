"""Qwen2-VL-7B language backbone [arXiv:2409.12191].

VLM: the ViT/SigLIP-style vision encoder + projector is a stub, as in the
reference — ``models/frontends.py`` supplies patch/text embeddings of shape
(B, S, d_model) and the M-RoPE positions of an image span. M-RoPE (multimodal
rotary with t/h/w sections) is implemented in the backbone. Qwen2 family uses
QKV bias.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        arch_type="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        rope_theta=1_000_000.0,
        m_rope=True,
        m_rope_sections=(16, 24, 24),
        qkv_bias=True,
        norm_type="rmsnorm",
        mlp_act="silu",
        embed_inputs=True,  # vision/text frontend stubbed -> embeddings in
        source="arXiv:2409.12191",
    )


def smoke_config() -> ModelConfig:
    return config().reduced(m_rope_sections=(8, 12, 12))
