"""K3 (flash_attention) of the port against the JAX package on the CPU: the
wrapper's plain path against the Pallas kernel run in interpret mode (head
dims 64, 80 and 128), the plain versions against each other on ragged
shapes, and ``ops.attention`` (GQA) and ``attention.attend`` against the
reference's. Inputs come from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import flash_attention_ref as jflash_ref
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention

torch.set_num_threads(1)


def _qkv(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in shapes]


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 100)])
@pytest.mark.parametrize("bh,sq,sk,d", [(4, 256, 256, 64), (2, 128, 512, 128),
                                        (3, 128, 256, 80)])
def test_plain_matches_pallas_kernel(bh, sq, sk, d, causal, window):
    """f32 at the JAX kernel test's tolerance (2e-5: sums and exp in
    another order)."""
    q, k, v = _qkv(((bh, sq, d), (bh, sk, d), (bh, sk, d)), bh * sq + sk)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    assert flash_attention.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_plain_matches_pallas_kernel_bf16():
    q, k, v = _qkv(((2, 128, 64),) * 3, 9)
    want = jflash(*[jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)],
                  interpret=True)
    got = flash_attention(*[torch.from_numpy(t).bfloat16()
                            for t in (q, k, v)])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 37),
                                           (True, 50)])
def test_plain_matches_reference_ragged(causal, window):
    """Sq != Sk, neither a multiple of a tile: the plain versions agree."""
    q, k, v = _qkv(((1, 3, 100, 64), (1, 3, 300, 64), (1, 3, 300, 64)), 2)
    want = jflash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("use_cuda", [True, False])
def test_ops_attention_gqa_matches_reference(use_cuda):
    """GQA (8 query heads over 2 KV heads) against the reference's kernel
    ops (interpret mode); both KernelConfig settings agree on the CPU."""
    q, k, v = _qkv(((2, 128, 8, 64), (2, 128, 2, 64), (2, 128, 2, 64)), 4)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True,
                        kcfg=ops.KernelConfig(use_cuda=use_cuda))
    assert got.shape == (2, 128, 8, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
def test_attend_matches_reference_xla_path(causal, window):
    """The model's attend (to K3) against the reference's XLA attention with
    positions from 0, MQA (4 heads over 1 KV head)."""
    q, k, v = _qkv(((2, 40, 4, 64), (2, 40, 1, 64), (2, 40, 1, 64)), 5)
    pos = jnp.arange(40)
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                        pos, causal, window)
    got = attention.attend(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), None, None, causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
