"""The Mamba-2 mixer's causal conv on the CPU: the backward kernel's formula
(``kernels/ref.causal_conv_bwd_ref``) against ``jax.vjp`` of the
reference's ``models/ssm._causal_conv`` and against autograd through the
port's plain ``_causal_conv``; ``CausalConv`` on CPU tensors (the plain
forward to the bit, the formula's gradients); the decode state that
prefill keeps. The kernels themselves run in ``tests/test_torch_cuda.py``.

Shapes: wc 4 and 2, S = 1, S = 2 < wc - 1, a width that is not a multiple
of 8, G = 1 (B and C of N channels each) and more than one run of 32
tokens. Tolerances, |got - want| <= rtol |want| + atol max|want|:
- f32: (1e-5, 1e-5), the same f32 operations in another order;
- bf16 against JAX in f32 on the same bf16 values (the function's own
  gradient): (2^-7, 2^-7), the formula's one rounding of each gradient
  plus the forward's bf16 pre-activation, which it differentiates at;
- bf16 against JAX in bf16 and against autograd through the plain version:
  (2^-5, 2^-5) and (2^-6, 2^-6): those round g, each shifted slice's
  gradient and their sums to bf16 on the way (measured gaps 1.1e-2 and
  7.7e-3 of max|want|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.kernels.causal_conv import causal_conv_backward
from repro_torch.kernels.ref import causal_conv_bwd_ref
from repro_torch.models import ssm

torch.set_num_threads(1)

# (batch, S, di, G*N, wc)
SHAPES = [(2, 70, 24, 16, 4), (2, 1, 20, 6, 4), (1, 2, 12, 4, 4),
          (2, 9, 13, 3, 4), (2, 33, 24, 8, 2), (3, 40, 32, 16, 4)]
DTYPES = [torch.float32, torch.bfloat16]
TOL = {"f32": (1e-5, 1e-5), "jax-f32": (2.0 ** -7, 2.0 ** -7),
       "jax-bf16": (2.0 ** -5, 2.0 ** -5), "autograd": (2.0 ** -6, 2.0 ** -6)}


def _inputs(shape, dtype, seed):
    """(x, B, C, w, b, the three cotangents) in ``dtype``."""
    bt, s, di, gn, wc = shape
    rng = np.random.default_rng(seed)

    def draw(*dims, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(dims) * scale).astype(np.float32)).to(dtype)

    ch = di + 2 * gn
    return (draw(bt, s, di), draw(bt, s, gn), draw(bt, s, gn),
            draw(ch, wc, scale=0.3), draw(ch, scale=0.1),
            (draw(bt, s, di), draw(bt, s, gn), draw(bt, s, gn)))


def _close(got, want, tol):
    rtol, atol = TOL[tol]
    got, want = got.double(), want.double()
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=atol * float(want.abs().max()))


def _ids(shape):
    return "b{}s{}di{}gn{}wc{}".format(*shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_causal_conv_bwd_ref_matches_jax_vjp(shape, dtype):
    """The formula against ``jax.vjp`` of the reference's conv, in f32 on
    the same values and, for bf16 inputs, in bf16 too."""
    x, B, C, w, b, douts = _inputs(shape, dtype, 1)
    xbc, dy = torch.cat([x, B, C], -1), torch.cat(douts, -1)
    got = causal_conv_bwd_ref(xbc, w, b, dy)
    runs = [(np.float32, "f32" if dtype == torch.float32 else "jax-f32")]
    if dtype == torch.bfloat16:
        runs.append((jnp.bfloat16, "jax-bf16"))
    for jdtype, tol in runs:
        vals = [jnp.asarray(t.float().numpy()).astype(jdtype)
                for t in (xbc, w, b)]
        _, vjp = jax.vjp(jssm._causal_conv, *vals)
        want = vjp(jnp.asarray(dy.float().numpy()).astype(jdtype))
        for g, v in zip(got, want):
            _close(g, torch.tensor(np.asarray(v.astype(jnp.float32))),
                   tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_causal_conv_bwd_ref_matches_autograd_through_plain(shape, dtype):
    x, B, C, w, b, douts = _inputs(shape, dtype, 2)
    leaves = [t.clone().requires_grad_(True)
              for t in (torch.cat([x, B, C], -1), w, b)]
    dy = torch.cat(douts, -1)
    want = torch.autograd.grad(ssm._causal_conv(*leaves), leaves, dy)
    got = causal_conv_bwd_ref(*(t.detach() for t in leaves), dy)
    for g, v in zip(got, want):
        assert g.dtype == v.dtype and g.shape == v.shape
        _close(g, v, "f32" if dtype == torch.float32 else "autograd")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_causal_conv_function_on_cpu(shape, dtype):
    """``ops.causal_conv`` with ``use_cuda`` on CPU tensors: the plain
    forward (``use_cuda=False``, the cat and ``_causal_conv``) to the bit,
    as views of one buffer, and the formula's gradients to the bit; an
    unused part's cotangent (None) counts as zero."""
    x, B, C, w, b, douts = _inputs(shape, dtype, 3)
    leaves = [t.clone().requires_grad_(True) for t in (x, B, C, w, b)]
    outs = ops.causal_conv(*leaves, kcfg=ops.KernelConfig(use_cuda=True))
    plain = ops.causal_conv(x, B, C, w, b,
                            kcfg=ops.KernelConfig(use_cuda=False))
    want = ssm._causal_conv(torch.cat([x, B, C], -1), w, b)
    assert torch.equal(torch.cat(outs, -1), want)
    assert all(torch.equal(o, p) for o, p in zip(outs, plain))
    assert len({o.untyped_storage().data_ptr() for o in outs}) == 1
    got = torch.autograd.grad(outs[:2], leaves, douts[:2])
    dy = torch.cat([douts[0], douts[1], torch.zeros_like(douts[2])], -1)
    gx, gw, gb = causal_conv_bwd_ref(torch.cat([x, B, C], -1), w, b, dy)
    di, gn = x.shape[-1], B.shape[-1]
    for g, v in zip(got, (gx[..., :di], gx[..., di:di + gn],
                          gx[..., di + gn:], gw, gb)):
        assert torch.equal(g, v)
    # what needs no gradient gets none
    assert causal_conv_backward(x, B, C, w, b, *douts,
                                needs=(True, False, True, False, False))[
        1::2] == (None, None)


@pytest.mark.parametrize("s", [1, 2, 3, 9])
def test_conv_tail_is_the_last_raw_frames(s):
    """The decode state prefill keeps: the last wc-1 frames of x, B and C
    side by side, zero in front of a prompt shorter than that."""
    bt, di, G, N, wc = 2, 12, 2, 4, 4
    g = torch.Generator().manual_seed(s)
    x = torch.randn(bt, s, di, generator=g)
    Braw = torch.randn(bt, s, G, N, generator=g)
    Craw = torch.randn(bt, s, G, N, generator=g)
    raw = torch.cat([x, Braw.reshape(bt, s, -1), Craw.reshape(bt, s, -1)],
                    -1)
    want = F.pad(raw, (0, 0, max(wc - 1 - s, 0), 0))[:, -(wc - 1):]
    got = ssm._conv_tail(x, Braw, Craw, wc)
    assert got.shape == (bt, wc - 1, di + 2 * G * N)
    assert torch.equal(got, want)

