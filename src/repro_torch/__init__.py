"""PyTorch / CUDA port of the deadline-aware online scheduler.

Mirrors the JAX package ``repro`` module for module (``configs``, ``core``,
``kernels``, ``models``, ``serve``). It holds the online policy-selection
path (batched forecast prep, the pool simulator, utility normalization, the
EG selector) and dense-model serving (prefill and decode of the dense
configs, with LoRA adapters). The TPU kernels on those paths run as
hand-written CUDA kernels on the card: the CHC window DP (``kernels/
window_dp``), the fused base + LoRA projection (``kernels/lora_matmul``) and
flash attention (``kernels/flash_attention``). The package never imports
``jax`` or ``repro``; ``convert`` carries state and weights across from the
reference as numpy arrays.
"""
