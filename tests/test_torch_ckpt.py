"""The port's checkpoints: the round-trip and corruption behaviours of
tests/test_ckpt_hardening.py and tests/test_substrate.py (CRC envelope,
atomic writes, bounded retries; the reference's legacy blob has no
counterpart, since the port never wrote a blob without an envelope), the
switching-cost model against the reference, and a training state (LoRA
leaves, AdamW state, step) restored onto its template's device."""
import inspect
import os
import zlib

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro_torch import convert
from repro_torch.checkpoint import (CheckpointCorruptError, checkpoint_bytes,
                                    deserialize, reconfiguration_mu, restore,
                                    save, serialize, transfer_seconds)
from repro_torch.checkpoint import ckpt as _ckpt
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.train.step import init_opt_state
from repro_torch.utils.partition import is_lora_path, partition_by_path


def _tree():
    return {
        "w": np.arange(12, dtype=np.float32).reshape(3, 4),
        "step": np.int64(7),
    }


def _assert_tree_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a["w"]), np.asarray(b["w"]))
    assert int(a["step"]) == int(b["step"])


def test_roundtrip_exact_dtypes_and_meta():
    tree = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((5,), dtype=torch.bfloat16) * 1.5,
              "d": torch.tensor(7, dtype=torch.int32)},
        "e": [torch.tensor([True, False]), np.float64(2.5), 3],
    }
    back, meta = deserialize(serialize(tree, {"k": 1}), tree)
    assert meta == {"k": 1}
    for x, y in ((tree["a"], back["a"]), (tree["b"]["c"], back["b"]["c"]),
                 (tree["b"]["d"], back["b"]["d"]),
                 (tree["e"][0], back["e"][0])):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert float(back["e"][1]) == 2.5 and int(back["e"][2]) == 3
    assert back["e"][1].dtype == torch.float64


def test_roundtrip_with_meta(tmp_path):
    path = str(tmp_path / "ck.bin")
    tree = _tree()
    nbytes = save(path, tree, meta={"arch": "t"})
    assert nbytes == os.path.getsize(path)
    out, meta = restore(path, tree)
    _assert_tree_equal(out, tree)
    assert meta == {"arch": "t"}
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_file_roundtrip_bf16(tmp_path):
    tree = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
    p = str(tmp_path / "x.ckpt")
    assert save(p, tree) > 0 and os.path.exists(p)
    back, _ = restore(p, tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])


def test_bitflip_raises_corrupt(tmp_path):
    path = str(tmp_path / "ck.bin")
    save(path, _tree())
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(CheckpointCorruptError):
        restore(path, _tree())


def test_truncation_raises_corrupt(tmp_path):
    path = str(tmp_path / "ck.bin")
    save(path, _tree())
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[: len(blob) - 8])
    with pytest.raises(CheckpointCorruptError):
        restore(path, _tree())


def _envelope(body: bytes, crc: int, n: int) -> bytes:
    return zlib.compress(_ckpt.MAGIC + _ckpt._ENVELOPE.pack(crc, n) + body)


def test_crc_mismatch_message(tmp_path):
    # decompresses fine, envelope intact, CRC wrong: the envelope's case
    body = serialize({}, {})
    inner = zlib.decompress(body)[len(_ckpt.MAGIC) + _ckpt._ENVELOPE.size:]
    path = str(tmp_path / "ck.bin")
    open(path, "wb").write(_envelope(inner, zlib.crc32(inner) ^ 1,
                                     len(inner)))
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        restore(path, {})
    open(path, "wb").write(_envelope(inner[:-1], zlib.crc32(inner[:-1]),
                                     len(inner)))
    with pytest.raises(CheckpointCorruptError, match="truncated"):
        restore(path, {})


def test_undecodable_body_and_wrong_template_raise_corrupt(tmp_path):
    path = str(tmp_path / "ck.bin")
    open(path, "wb").write(zlib.compress(b"not a checkpoint at all"))
    with pytest.raises(CheckpointCorruptError, match="no envelope"):
        restore(path, {})
    body = b"\xff" * 12
    open(path, "wb").write(_envelope(body, zlib.crc32(body), len(body)))
    with pytest.raises(CheckpointCorruptError, match="undecodable"):
        restore(path, {})
    save(path, _tree())
    with pytest.raises(CheckpointCorruptError, match="template"):
        restore(path, {"w": np.zeros(1)})


class _Flaky:
    """Raise OSError the first ``n_fail`` calls, then delegate."""

    def __init__(self, n_fail, fn):
        self.n_fail, self.fn, self.calls = n_fail, fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.calls <= self.n_fail:
            raise OSError(f"transient #{self.calls}")
        return self.fn(*a, **kw)


def test_save_retries_transient_oserror(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.bin")
    flaky = _Flaky(2, _ckpt._write_bytes_atomic)
    monkeypatch.setattr(_ckpt, "_write_bytes_atomic", flaky)
    save(path, _tree(), retries=2, backoff=0.0)
    assert flaky.calls == 3
    out, _ = restore(path, _tree())
    _assert_tree_equal(out, _tree())


def test_save_retry_exhaustion_propagates(tmp_path, monkeypatch):
    flaky = _Flaky(10, _ckpt._write_bytes_atomic)
    monkeypatch.setattr(_ckpt, "_write_bytes_atomic", flaky)
    with pytest.raises(OSError, match="transient"):
        save(str(tmp_path / "ck.bin"), _tree(), retries=2, backoff=0.0)
    assert flaky.calls == 3  # first attempt + exactly `retries` retries


def test_restore_retries_transient_oserror(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.bin")
    save(path, _tree())
    flaky = _Flaky(1, _ckpt._read_bytes)
    monkeypatch.setattr(_ckpt, "_read_bytes", flaky)
    out, _ = restore(path, _tree(), retries=1, backoff=0.0)
    assert flaky.calls == 2
    _assert_tree_equal(out, _tree())


def test_corruption_is_never_retried(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.bin")
    save(path, _tree())
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    reads = _Flaky(0, _ckpt._read_bytes)
    monkeypatch.setattr(_ckpt, "_read_bytes", reads)
    with pytest.raises(CheckpointCorruptError):
        restore(path, _tree(), retries=5, backoff=0.0)
    assert reads.calls == 1  # a bad CRC does not heal on a reread


def test_atomic_write_leaves_no_tmp_on_failure(tmp_path, monkeypatch):
    # fail the replace: the target must not exist and the tmp is cleaned
    def boom(src, dst):
        raise OSError("replace failed")

    monkeypatch.setattr(_ckpt.os, "replace", boom)
    path = str(tmp_path / "ck.bin")
    with pytest.raises(OSError):
        _ckpt._write_bytes_atomic(path, b"payload")
    assert not os.path.exists(path)
    assert os.listdir(tmp_path) == []


def test_training_state_roundtrip_onto_template_device(tmp_path):
    """The elastic trainer's state: the LoRA leaves, the AdamW state (an
    int32 step, f32 moments) and the step, bit for bit, on the template's
    device and dtype."""
    cfg = get_smoke_config("tiny-100m")
    params = convert.model_params(convert.random_model_params(cfg, 1), cfg,
                                  "cpu")
    lora, _ = partition_by_path(params, is_lora_path)
    opt = init_opt_state(params)
    opt = opt._replace(step=opt.step + 5,
                       m=[torch.randn_like(x) for x in opt.m])
    state = {"lora": lora, "opt": opt, "step": 12}
    path = str(tmp_path / "state.ckpt")
    save(path, state, meta={"arch": cfg.name})
    back, meta = restore(path, state)
    assert meta == {"arch": cfg.name} and int(back["step"]) == 12
    assert type(back["opt"]) is type(opt)
    assert back["opt"].step.dtype == torch.int32 and int(back["opt"].step) == 5
    for a, b in zip(back["lora"] + back["opt"].m + back["opt"].v,
                    lora + opt.m + opt.v):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_elastic_trainer_threads_retries():
    from repro_torch.train.elastic import ElasticTrainer

    assert "ckpt_retries" in inspect.signature(ElasticTrainer).parameters
    src = inspect.getsource(ElasticTrainer._reconfigure)
    assert "retries=self.ckpt_retries" in src


@pytest.mark.parametrize("arch", list_archs())
def test_switching_cost_model_equals_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert checkpoint_bytes(cfg) == jckpt.checkpoint_bytes(jcfg)
    for bw in (200e9, 800e6, 100e6):
        assert transfer_seconds(cfg, bw) == jckpt.transfer_seconds(jcfg, bw)
        assert reconfiguration_mu(cfg, bw, 1800.0) == \
            jckpt.reconfiguration_mu(jcfg, bw, 1800.0)


def test_switching_cost_matches_paper_numbers():
    """Paper Sec. II-A: LLaMA2-7B checkpoint = 0.58 s @ 200 Gbps RDMA and
    1152 s @ 100 Mbps."""
    cfg = get_config("llama2-7b")
    assert transfer_seconds(cfg, 200e9) == pytest.approx(0.58, rel=0.15)
    assert transfer_seconds(cfg, 100e6) == pytest.approx(1152.0, rel=0.15)
    assert checkpoint_bytes(cfg) == pytest.approx(14.0e9, rel=0.15)
