"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only audio transformer (w2v2 arch).

Audio: the mel-spectrogram + conv feature extractor frontend is a stub, as in
the reference — ``models/frontends.py`` supplies frame embeddings (B, S,
d_model). Training objective is masked prediction over 504 codebook classes.
Encoder-only: ``forward`` only; prefill, decode and the serving engine refuse it.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        arch_type="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,      # codebook targets
        causal=False,
        encoder_only=True,
        embed_inputs=True,   # conv/mel frontend stubbed -> frame embeddings in
        norm_type="layernorm",
        mlp_act="gelu",
        mlp_bias=True,
        qkv_bias=True,
        o_bias=True,
        rope_theta=0.0,      # no RoPE; w2v2 uses conv positional (in stub frontend)
        source="arXiv:2106.07447",
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
