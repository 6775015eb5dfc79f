"""Checkpoints of a tree of tensors, and the switching-cost model (the
reference's ``checkpoint/ckpt.py``).

This is the substrate behind the paper's switching cost (Sec. II-A): when
the spot scheduler changes the instance count or a preemption hits, the
fine-tuning state (LoRA leaves, optimizer state, data-stream position) is
written, shipped over the network and restored. ``checkpoint_bytes`` and
``transfer_seconds`` model that from a config's sizes.

The format is the standard library's alone (the card's machine has neither
msgpack nor zstandard), so the bytes differ from the reference's; the
behaviours are the reference's:

- the body: an 8-byte little-endian header length, a JSON header (``meta``
  and each leaf's dtype, shape, byte offset and length) and the leaves' raw
  bytes (bf16 as its uint16 bits);
- the envelope: ``MAGIC``, then the CRC32 of the body and its length
  (``struct`` "<IQ"), then the body; the whole is zlib-compressed;
- writes are atomic (tmp + rename in the target's directory), ``save`` and
  ``restore`` retry transient ``OSError`` s with exponential backoff, and
  corruption (a bad CRC, truncation, an undecodable blob) raises
  :class:`CheckpointCorruptError` and is never retried.

The reference also restores blobs written before its CRC envelope; the
port never wrote a blob without one, so it has no such case.

Restored leaves are tensors on the device of the template tree's leaf (the
CPU where the template's leaf is not a tensor), in the saved dtype.
"""
from __future__ import annotations

import json
import os
import struct
import tempfile
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import flatten, unflatten

MAGIC = b"RTCKPT1\0"
_ENVELOPE = struct.Struct("<IQ")     # CRC32 of the body, body length
_HEADER_LEN = struct.Struct("<Q")


class CheckpointCorruptError(RuntimeError):
    """The checkpoint file is damaged: CRC mismatch, truncation, or an
    undecodable body. Retrying the read will not help."""


def _leaf_bytes(x) -> Tuple[str, list, bytes]:
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return dtype, list(x.shape), t.numpy().tobytes()
    arr = np.ascontiguousarray(np.asarray(x))
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def _leaf_tensor(dtype: str, shape, data: bytes, like) -> torch.Tensor:
    raw_dtype = np.int16 if dtype == "bfloat16" else np.dtype(dtype)
    arr = np.frombuffer(data, raw_dtype).reshape(shape)
    t = torch.from_numpy(arr.copy())
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    device = like.device if torch.is_tensor(like) else "cpu"
    return t.to(device)


def serialize(tree, meta: Optional[Dict[str, Any]] = None) -> bytes:
    leaves, _ = flatten(tree)
    specs, chunks, offset = [], [], 0
    for leaf in leaves:
        dtype, shape, data = _leaf_bytes(leaf)
        specs.append({"dtype": dtype, "shape": shape, "offset": offset,
                      "nbytes": len(data)})
        chunks.append(data)
        offset += len(data)
    header = json.dumps({"meta": meta or {}, "leaves": specs}).encode()
    body = b"".join([_HEADER_LEN.pack(len(header)), header, *chunks])
    # the CRC covers the whole body, so a truncation or bit flip that
    # survives decompression is still caught
    raw = MAGIC + _ENVELOPE.pack(zlib.crc32(body), len(body)) + body
    return zlib.compress(raw, 6)


def _open_envelope(blob: bytes) -> bytes:
    try:
        raw = zlib.decompress(blob)
    except zlib.error as e:
        raise CheckpointCorruptError(
            f"checkpoint is undecodable (zlib: {e})") from e
    head = len(MAGIC) + _ENVELOPE.size
    if len(raw) < head or raw[:len(MAGIC)] != MAGIC:
        raise CheckpointCorruptError("checkpoint is undecodable: no "
                                     "envelope")
    crc, n = _ENVELOPE.unpack_from(raw, len(MAGIC))
    body = raw[head:]
    if len(body) != n:
        raise CheckpointCorruptError(
            f"checkpoint is truncated: body of {len(body)} bytes, the "
            f"envelope says {n}")
    if zlib.crc32(body) != crc:
        raise CheckpointCorruptError(
            "checkpoint checksum mismatch: the file decompressed but its "
            "body does not match the stored CRC32")
    return body


def deserialize(blob: bytes, tree_like) -> Tuple[Any, Dict[str, Any]]:
    body = _open_envelope(blob)
    templates, treedef = flatten(tree_like)
    try:
        (n,) = _HEADER_LEN.unpack_from(body, 0)
        header = json.loads(body[_HEADER_LEN.size:_HEADER_LEN.size + n])
        data = body[_HEADER_LEN.size + n:]
        specs = header["leaves"]
        if len(specs) != len(templates):
            raise ValueError(f"{len(specs)} leaves stored, the template has "
                             f"{len(templates)}")
        leaves = [_leaf_tensor(s["dtype"], s["shape"],
                               data[s["offset"]:s["offset"] + s["nbytes"]],
                               like)
                  for s, like in zip(specs, templates)]
    except CheckpointCorruptError:
        raise
    except (ValueError, KeyError, TypeError, struct.error) as e:
        raise CheckpointCorruptError(
            f"checkpoint is undecodable ({type(e).__name__}: {e})") from e
    return unflatten(treedef, leaves), header["meta"]


def _with_retries(fn, retries: int, backoff: float):
    """Run ``fn`` retrying transient ``OSError``s with exponential backoff
    (``retries`` extra attempts after the first). Corruption is never
    retried: a bad CRC will not heal on a reread."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except OSError:
            if attempt >= retries:
                raise
            time.sleep(backoff * (2 ** attempt))


def _write_bytes_atomic(path: str, blob: bytes) -> None:
    """tmp + rename in the target directory, so a crash mid-write never
    leaves a torn file at ``path`` (split out for fault-injection tests)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def save(path: str, tree, meta: Optional[Dict[str, Any]] = None, *,
         retries: int = 2, backoff: float = 0.05) -> int:
    """Atomic write; returns the byte size (it feeds the switching-cost
    model). Transient ``OSError``s are retried ``retries`` times with
    exponential backoff before propagating."""
    blob = serialize(tree, meta)
    _with_retries(lambda: _write_bytes_atomic(path, blob), retries, backoff)
    return len(blob)


def restore(path: str, tree_like, *, retries: int = 2,
            backoff: float = 0.05) -> Tuple[Any, Dict[str, Any]]:
    blob = _with_retries(lambda: _read_bytes(path), retries, backoff)
    return deserialize(blob, tree_like)


# ---------------------------------------------------------------------------
# Switching-cost model (paper Sec. II-A / VI-A)
# ---------------------------------------------------------------------------

def checkpoint_bytes(cfg) -> int:
    """Base model + LoRA + Adam moments, bf16 base / f32 adapters."""
    base = cfg.param_count() * 2
    lora = cfg.lora_param_count() * 4
    adam = cfg.lora_param_count() * 8  # m and v in f32
    return base + lora + adam


def transfer_seconds(cfg, bandwidth_bps: float) -> float:
    return checkpoint_bytes(cfg) * 8.0 / bandwidth_bps


def reconfiguration_mu(cfg, bandwidth_bps: float, slot_seconds: float,
                       startup_seconds: float = 180.0) -> float:
    """Effective-compute fraction of a slot after a scale-up event (Eq. 2):
    checkpoint transfer + container/startup time, clipped to [0, 1]."""
    dead = transfer_seconds(cfg, bandwidth_bps) + startup_seconds
    return float(np.clip(1.0 - dead / slot_seconds, 0.0, 1.0))
