"""PyTorch / CUDA port of the deadline-aware online scheduler.

Mirrors the JAX package ``repro`` module for module (``configs``, ``core``,
``kernels``, ``models``, ``serve``). It holds the online policy-selection
path (batched forecast prep, the pool simulator, utility normalization, the
EG selector) and model serving (prefill and decode of the dense, SSM and
hybrid configs, with LoRA adapters). Every TPU kernel of the reference
runs as a hand-written CUDA kernel on the card: the CHC window DP
(``kernels/window_dp``), the fused base + LoRA projection
(``kernels/lora_matmul``), flash attention (``kernels/flash_attention``)
and the Mamba2 SSD chunk scan (``kernels/ssd_scan``). The package never
imports ``jax`` or ``repro``; ``convert`` carries state and weights across
from the reference as numpy arrays.
"""
