"""PyTorch / CUDA port of the deadline-aware online scheduler.

Mirrors the JAX package ``repro`` module for module (``configs``, ``core``,
``kernels``) and holds the online policy-selection path: batched forecast
prep, the pool simulator, utility normalization and the EG selector. The
CHC window DP runs as a hand-written CUDA kernel on the card
(``kernels/window_dp``). The package never imports ``jax`` or ``repro``;
``convert`` carries state across from the reference as numpy arrays.
"""
