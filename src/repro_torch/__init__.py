"""PyTorch / CUDA port of the deadline-aware online scheduler.

Mirrors the JAX package ``repro`` module for module (``configs``, ``core``,
``kernels``, ``models``, ``serve``, ``optim``, ``train``, ``data``,
``checkpoint``, ``utils``, ``launch``). It holds:

- the online policy-selection path (batched forecast prep, the pool
  simulator, utility normalization, the EG selector), its regional and
  fleet-contention variants, and the host reference chain they are held to;
- model serving (prefill and decode) of every family of the reference:
  dense, MoE (Mixtral), SSM (Mamba2), hybrid (Zamba2), VLM (Qwen2-VL, fed
  embeddings) and audio (HuBERT, an encoder), with LoRA adapters;
- LoRA fine-tuning, the paper's workload: the train step (microbatches,
  remat, only the LoRA leaves trained), AdamW and its schedule, the
  deterministic loader, checkpoints with a CRC envelope, and the elastic
  trainer that the scheduler drives slot by slot.

Every TPU kernel of the reference runs as a hand-written CUDA kernel on the
card: the CHC window DP (``kernels/window_dp``), the fused base + LoRA
projection (``kernels/lora_matmul``, whose backward is the same kernel on
the transposed operands), flash attention (``kernels/flash_attention``)
and the Mamba2 SSD chunk scan (``kernels/ssd_scan``). The package never
imports ``jax`` or ``repro``; ``convert`` carries state and weights across
from the reference as numpy arrays.
"""
