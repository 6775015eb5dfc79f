"""K4 (ssd_scan) of the port against the JAX package on the CPU: the plain
version against the Pallas kernel run in interpret mode and against the
reference's step-by-step oracle, ``ops.ssd`` (groups repeated to heads)
against the reference's, and the wrapper on CPU tensors. Inputs come from
numpy seeds, drawn as the JAX kernel tests draw theirs.

Tolerance 3e-4 (atol and rtol): the JAX kernel test's own for the chunked
kernel against the sequential oracle; the port's plain version is
sequential, and sums and exponentials are taken in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import ssd_scan_ref as jssd_ref
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan import ssd_scan

torch.set_num_threads(1)
TOL = dict(atol=3e-4, rtol=3e-4)


def _inputs(bh, s, p, n, seed):
    """x ~ N(0, 1), dt = softplus(N(0, 1)) / 2, A = -exp(N(0, 1)) / 2,
    B, C ~ 0.3 N(0, 1), all f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, p), np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((bh, s)))) * 0.5).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal(bh)) * 0.5).astype(np.float32)
    B = (rng.standard_normal((bh, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((bh, s, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bh,s,p,n,cs", [(4, 256, 64, 32, 64),
                                         (2, 256, 32, 128, 128)])
def test_plain_matches_pallas_kernel_and_oracle(bh, s, p, n, cs):
    """tests/test_kernels.py's shapes and chunks."""
    ins = _inputs(bh, s, p, n, bh * s + n)
    y, h = ssd_scan_ref(*_t(ins))
    for want_y, want_h in (jssd(*map(jnp.asarray, ins), chunk=cs,
                                interpret=True),
                           jssd_ref(*map(jnp.asarray, ins))):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    assert y.dtype == torch.float32 and h.shape == (bh, n, p)


@pytest.mark.parametrize("s", [37, 200])
def test_plain_matches_oracle_ragged(s):
    """S not a multiple of any chunk (the Pallas kernel refuses it)."""
    ins = _inputs(3, s, 32, 16, s)
    y, h = ssd_scan_ref(*_t(ins))
    want_y, want_h = jssd_ref(*map(jnp.asarray, ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_plain_bf16_rounds_y_once():
    """bf16 x, B, C: y comes back in bf16, the state in f32, equal to the
    f32 computation on the bf16-rounded inputs rounded once."""
    x, dt, A, B, C = _t(_inputs(2, 64, 32, 16, 5))
    xb, Bb, Cb = (t.bfloat16() for t in (x, B, C))
    y, h = ssd_scan_ref(xb, dt, A, Bb, Cb)
    y32, h32 = ssd_scan_ref(xb.float(), dt, A, Bb.float(), Cb.float())
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, y32.bfloat16()) and torch.equal(h, h32)


@pytest.mark.parametrize("use_cuda", [True, False])
def test_ops_ssd_matches_reference(use_cuda):
    """G = 2 groups over H = 4 heads (tests/test_kernels.py's shapes):
    against the reference's ops.ssd (Pallas in interpret mode); both
    KernelConfig settings agree on the CPU."""
    rng = np.random.default_rng(6)
    b, s, hh, p, g, n = 2, 128, 4, 32, 2, 16
    x = rng.standard_normal((b, s, hh, p), np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, hh)))) * 0.5).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal(hh)) * 0.5).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    want_y, want_h = jops.ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk=64)
    y, h = ops.ssd(*_t((x, dt, A, B, C)),
                   kcfg=ops.KernelConfig(use_cuda=use_cuda))
    assert y.shape == (b, s, hh, p) and h.shape == (b, hh, n, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    ins = _t(_inputs(2, 40, 64, 16, 7))
    before = ssd_scan.launches
    y, h = ssd_scan(*ins)
    want_y, want_h = ssd_scan_ref(*ins)
    assert ssd_scan.launches == before
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
