"""K4 (ssd_scan) of the port against the JAX package on the CPU: the plain
version against the Pallas kernel run in interpret mode and against the
reference's step-by-step oracle, ``ops.ssd`` against the reference's (also
on x, B and C as strided views of one conv-output buffer, the layout K4
reads in place), the wrapper on CPU tensors, and the layout rules K4 holds
the serving configurations to. Inputs come from
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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_grouped_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan import (check_layout, ssd_scan,
                                          ssd_scan_grouped)

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


def _xbc_views(b, s, hh, p, g, n, seed, dtype=torch.float32, device="cpu"):
    """x (b, s, hh, p), B and C (b, s, g, n) sliced out of one
    (b, s, hh p + 2 g n) buffer as models/ssm.apply_mamba slices its conv
    output; dt (b, s, hh), A (hh,). Values from a numpy seed (none on the
    meta device)."""
    di = hh * p
    shape = (b, s, di + 2 * g * n)
    if device == "meta":
        xbc = torch.empty(shape, dtype=dtype, device="meta")
        dt = torch.empty((b, s, hh), device="meta")
        A = torch.empty((hh,), device="meta")
    else:
        rng = np.random.default_rng(seed)
        buf = rng.standard_normal(shape, np.float32)
        buf[..., di:] *= 0.3
        xbc = torch.from_numpy(buf).to(dtype)
        dt = torch.from_numpy((np.log1p(np.exp(rng.standard_normal(
            (b, s, hh)))) * 0.5).astype(np.float32))
        A = torch.from_numpy((-np.exp(rng.standard_normal(hh)) * 0.5).astype(
            np.float32))
    return (xbc[..., :di].reshape(b, s, hh, p), dt, A,
            xbc[..., di:di + g * n].reshape(b, s, g, n),
            xbc[..., di + g * n:].reshape(b, s, g, n))


@pytest.mark.parametrize("use_cuda", [True, False])
@pytest.mark.parametrize("s", [37, 200])
@pytest.mark.parametrize("g", [1, 2])
def test_ops_ssd_on_xbc_views_matches_reference(g, s, use_cuda):
    """ops.ssd on the views K4 reads in place (H = 4, G groups, a ragged
    S) against the reference's ops.ssd, the Pallas kernel in interpret mode
    over one chunk of S steps; y comes back contiguous."""
    ins = _xbc_views(2, s, 4, 32, g, 16, 10 * s + g)
    assert not ins[0].is_contiguous() and not ins[3].is_contiguous()
    want_y, want_h = jops.ssd(*(jnp.asarray(t.numpy()) for t in ins),
                              chunk=s)
    y, h = ops.ssd(*ins, kcfg=ops.KernelConfig(use_cuda=use_cuda))
    assert y.shape == (2, s, 4, 32) and y.is_contiguous()
    assert h.shape == (2, 4, 16, 32) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_grouped_wrapper_runs_plain_version_on_cpu_tensors():
    """ssd_scan_grouped on CPU views: the plain version, equal to the
    flattened plain version on B and C repeated to heads; no launch."""
    x, dt, A, B, C = _xbc_views(2, 70, 4, 64, 2, 16, 3, torch.bfloat16)
    before = ssd_scan.launches
    y, h = ssd_scan_grouped(x, dt, A, B, C)
    assert ssd_scan.launches == before
    want_y, want_h = ssd_scan_grouped_ref(x, dt, A, B, C)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    flat_y, flat_h = ssd_scan_ref(
        x.transpose(1, 2).reshape(8, 70, 64),
        dt.transpose(1, 2).reshape(8, 70), A.repeat(2),
        *(t.repeat_interleave(2, dim=2).transpose(1, 2).reshape(8, 70, 16)
          for t in (B, C)))
    assert torch.equal(y, flat_y.reshape(2, 4, 70, 64).transpose(1, 2))
    assert torch.equal(h, flat_h.reshape(2, 4, 16, 64))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_serving_layouts_meet_k4_layout_rules(arch, smoke):
    """Every configuration the port serves, at full size and at smoke size,
    hands K4 views it takes in place: rows of d_inner + 2 G N elements, a
    multiple of 8, and slice offsets that are multiples of 8 (meta tensors:
    no memory)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    sc = cfg.ssm
    d = cfg.d_model
    hh, p, g, n = sc.heads(d), sc.head_dim, sc.n_groups, sc.state_size
    ins = _xbc_views(8, 2048, hh, p, g, n, 0, torch.bfloat16, "meta")
    check_layout(*ins)
    width = sc.d_inner(d) + 2 * g * n
    assert ins[0].stride(1) == width and width % 8 == 0
    assert (width, p, n) == ({("mamba2-370m", False): (2304, 64, 128),
                              ("zamba2-2.7b", False): (5248, 64, 64)}
                             .get((arch, smoke), (544, 32, 16)))


def _refused(case):
    x, dt, A, B, C = _xbc_views(2, 64, 4, 32, 2, 16, 0, torch.bfloat16,
                                "meta")
    if case == "stride":      # x in rows of 196 elements
        buf = torch.empty((2, 64, 196), dtype=torch.bfloat16, device="meta")
        return buf[..., :128].reshape(2, 64, 4, 32), dt, A, B, C
    if case == "offset":      # B starting 4 elements into its rows
        buf = torch.empty((2, 64, 48), dtype=torch.bfloat16, device="meta")
        return x, dt, A, buf[..., 4:36].reshape(2, 64, 2, 16), C
    if case == "last_dim":
        return x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C
    if case == "groups":      # H = 3 heads over G = 2 groups
        return x[:, :, :3], dt[:, :, :3], A[:3], B, C
    big = torch.empty((2, 64, 2, 136), dtype=torch.bfloat16, device="meta")
    if case == "state":       # N = 136
        return x, dt, A, big, big
    return x.reshape(2, 64, 2, 64)[..., :48], dt[:, :, :2], A[:2], B, C


@pytest.mark.parametrize("case,match", [
    ("stride", "multiples of 8"), ("offset", "multiples of 8"),
    ("last_dim", "contiguous last dimension"), ("groups", "H a multiple of G"),
    ("state", "state N"), ("head_dim", "head_dim")])
def test_check_layout_refuses(case, match):
    """The layouts K4 does not take raise, whatever the device: a stride or
    offset off the 16-byte copies, a strided last dimension, H not a
    multiple of G, N > 128, P outside {32, 64}."""
    with pytest.raises(ValueError, match=match):
        check_layout(*_refused(case))
