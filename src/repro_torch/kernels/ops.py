"""The model layer's entry points to the kernels (the reference's
``kernels/ops.py``).

``KernelConfig(use_cuda=True)`` routes each call to its kernel's
``torch.autograd.Function`` (K2 ``LoRAMatmul``, K3 ``FlashAttention``, K4
``SSDScan``), whose forward launches the CUDA kernel on a CUDA tensor and
runs the plain version on a CPU tensor, so a model trains through the
kernels too. ``use_cuda=False`` runs the plain PyTorch version on any
device: it exists so that one model can run both ways on the card for
comparison, not as a fallback.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.lora_matmul import LoRAMatmul
from repro_torch.kernels.ssd_scan import SSDScan
from repro_torch.obs import ranges


@dataclass(frozen=True)
class KernelConfig:
    use_cuda: bool = True


DEFAULT = KernelConfig()
SSD_COPIES = "ops.ssd repeat and flatten"
KV_REPEAT = "ops.attention repeat kv"


_lora = LoRAMatmul.apply
_flash = FlashAttention.apply
_ssd = SSDScan.apply


@ranges.stage(ranges.LORA_MATMUL)
def lora_matmul(x, w, a, b, scale: float,
                kcfg: KernelConfig = DEFAULT) -> torch.Tensor:
    """y = x @ W + scale * (x@A)@B. x (..., K) is flattened to 2-D; W may be
    (K, N) or (K, h, hd) and B (r, N) or (r, h, hd). Returns (..., *W.shape[1:])
    in x's dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    w2 = w.reshape(w.shape[0], -1)
    b2 = b.reshape(b.shape[0], -1)
    if kcfg.use_cuda:
        y = _lora(x2, w2, a, b2, scale)
    else:
        y = ref.lora_matmul_ref(x2, w2, a, b2, scale)
    return y.reshape(*lead, *w.shape[1:])


@ranges.stage(ranges.ATTENTION)
def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_pos: Optional[torch.Tensor] = None,
              k_pos: Optional[torch.Tensor] = None,
              kcfg: KernelConfig = DEFAULT) -> torch.Tensor:
    """q (B, Sq, H, D), k / v (B, Sk, KV, D) with GQA -> (B, Sq, H, D).
    q_pos (Sq,) and k_pos (Sk,) int32 are the positions that mask, shared
    by the batch; omitted, they count from 0 for queries and keys."""
    b, sq, h, d = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        # GQA: K and V copied to every query head before K3 (named, so that
        # a profiler trace shows the copies' device time)
        with ranges.span(KV_REPEAT):
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
    sk = k.shape[1]
    qt = q.transpose(1, 2).reshape(b * h, sq, d).contiguous()
    kt = k.transpose(1, 2).reshape(b * h, sk, d).contiguous()
    vt = v.transpose(1, 2).reshape(b * h, sk, d).contiguous()
    if kcfg.use_cuda:
        o = _flash(qt, kt, vt, causal, window, q_pos, k_pos)
    else:
        o = ref.flash_attention_ref(
            qt.reshape(b, h, sq, d), kt.reshape(b, h, sk, d),
            vt.reshape(b, h, sk, d), causal=causal, window=window,
            q_pos=q_pos, k_pos=k_pos,
        ).reshape(b * h, sq, d)
    return o.reshape(b, h, sq, d).transpose(1, 2)


@ranges.stage(ranges.SSD)
def ssd(x, dt, A, B, C, *, kcfg: KernelConfig = DEFAULT):
    """Grouped-head SSD: x (B, S, H, P), dt (B, S, H) f32, A (H,) f32,
    B / C (B, S, G, N). Returns (y (B, S, H, P) contiguous in x's dtype,
    state (B, H, N, P) f32).

    With ``kcfg.use_cuda`` K4 reads x, B and C where they lie (strided
    views, B and C per group) and writes y in place: nothing is copied.
    Otherwise the plain version repeats B and C from groups to heads and
    flattens every operand to (B*H, ...) copies, as the reference does. The
    reference's ``chunk`` argument is the TPU kernel's tile: K4 picks its
    own and the plain version is step by step, so there is none here."""
    # named so that a profiler trace shows what preparation costs (dt and
    # A arrive in f32: no copy)
    with ranges.span(SSD_COPIES):
        dt, A = dt.float(), A.float()
    if kcfg.use_cuda:
        return _ssd(x, dt, A, B, C)
    return ref.ssd_scan_grouped_ref(x, dt, A, B, C)
