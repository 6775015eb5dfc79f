"""K2 (lora_matmul) of the port against the JAX package on the CPU: the
wrapper's plain path against the Pallas kernel run in interpret mode, the
ops-level flattening against the reference's ops and model paths, and the
LoRA helpers of ``models/lora.py``. Inputs come from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.lora_matmul import lora_matmul as jlora_matmul
from repro.models import lora as jlora
from repro_torch.kernels import ops
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.models import lora

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the JAX package's kernel-test tolerances: f32 sums in another order
# (1e-5); bf16 one rounding of the output (3e-2)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(m, k, n, r, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), np.float32)
    w, a, b = (rng.standard_normal(s, np.float32) * 0.05
               for s in ((k, n), (k, r), (r, n)))
    return x, w, a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", [(128, 128, 128, 16), (256, 384, 128, 8),
                                     (128, 256, 256, 64)])
def test_plain_matches_pallas_kernel(m, k, n, r, dtype):
    arrays = _inputs(m, k, n, r, m + k + n + r)
    jdt, tdt = DTYPES[dtype]
    want = jlora_matmul(*[jnp.asarray(t).astype(jdt) for t in arrays], 2.0,
                        interpret=True)
    got = lora_matmul(*[torch.from_numpy(t).to(tdt) for t in arrays], 2.0)
    assert got.dtype == tdt and lora_matmul.launches == 0
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_zero_b_equals_base():
    x, w, a, _ = _inputs(128, 128, 128, 16, 0)
    b = np.zeros((16, 128), np.float32)
    got = lora_matmul(*[torch.from_numpy(t) for t in (x, w, a, b)], 2.0)
    np.testing.assert_allclose(got.numpy(), x @ w, atol=1e-4, rtol=1e-4)


def test_ops_flattens_leading_dims_and_heads():
    """ops.lora_matmul on x (B, S, d), W (d, h, hd), B (r, h, hd) against
    the reference's XLA projection (lora.proj) and its kernel ops wrapper
    (2-D W, interpret mode)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64), np.float32)
    w = rng.standard_normal((64, 4, 16), np.float32) * 0.1
    a = rng.standard_normal((64, 8), np.float32) * 0.1
    b = rng.standard_normal((8, 4, 16), np.float32) * 0.1
    got = ops.lora_matmul(*[torch.from_numpy(t) for t in (x, w, a, b)], 2.0)
    assert got.shape == (2, 5, 4, 16)
    want = jlora.proj(jnp.asarray(x), jnp.asarray(w), None,
                      {"a": jnp.asarray(a), "b": jnp.asarray(b)}, 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    want_k = jops.lora_matmul(jnp.asarray(x), jnp.asarray(w.reshape(64, 64)),
                              jnp.asarray(a), jnp.asarray(b.reshape(8, 64)),
                              2.0)
    np.testing.assert_allclose(got.reshape(2, 5, 64).numpy(),
                               np.asarray(want_k), atol=1e-5, rtol=1e-5)
    plain = ops.lora_matmul(*[torch.from_numpy(t) for t in (x, w, a, b)],
                            2.0, ops.KernelConfig(use_cuda=False))
    assert torch.equal(plain, got)


@pytest.mark.parametrize("with_bias", [False, True])
def test_proj_matches_reference(with_bias):
    """proj with an adapter (K2's plain path) and without, bias added after
    the delta (the reference adds it before: f32 reassociation)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 32), np.float32)
    w = rng.standard_normal((32, 2, 8), np.float32) * 0.2
    bias = rng.standard_normal((2, 8), np.float32) if with_bias else None
    pair = {"a": rng.standard_normal((32, 4), np.float32) * 0.2,
            "b": rng.standard_normal((4, 2, 8), np.float32) * 0.2}
    tb = None if bias is None else torch.from_numpy(bias)
    for adapter in (None, pair):
        got = lora.proj(torch.from_numpy(x), torch.from_numpy(w), tb,
                        None if adapter is None else
                        {k: torch.from_numpy(v) for k, v in adapter.items()},
                        2.0)
        want = jlora.proj(jnp.asarray(x), jnp.asarray(w),
                          None if bias is None else jnp.asarray(bias),
                          None if adapter is None else
                          jax.tree.map(jnp.asarray, adapter), 2.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_lora_delta_and_merge_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 16), np.float32)
    w = rng.standard_normal((16, 3, 4), np.float32)
    pair = {"a": rng.standard_normal((16, 2), np.float32),
            "b": rng.standard_normal((2, 3, 4), np.float32)}
    tpair = {k: torch.from_numpy(v) for k, v in pair.items()}
    jpair = jax.tree.map(jnp.asarray, pair)
    np.testing.assert_allclose(
        lora.lora_delta(torch.from_numpy(x), tpair, 2.0).numpy(),
        np.asarray(jlora.lora_delta(jnp.asarray(x), jpair, 2.0)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        lora.merge_lora(torch.from_numpy(w), tpair, 2.0).numpy(),
        np.asarray(jlora.merge_lora(jnp.asarray(w), jpair, 2.0)),
        atol=1e-5, rtol=1e-5)


def test_init_lora_pair_zero_b():
    gen = torch.Generator().manual_seed(0)
    pair = lora.init_lora_pair(gen, 32, (2, 8), 4)
    assert pair["a"].shape == (32, 4) and pair["a"].dtype == torch.float32
    assert pair["b"].shape == (4, 2, 8) and not pair["b"].any()
