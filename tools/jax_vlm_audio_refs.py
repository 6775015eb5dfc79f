"""Record the JAX package's results on chip_smoke.py's ``[vlm-ref]`` and
``[audio-ref]`` phases, which hold the PyTorch port to them on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_vlm_audio_refs.py

Runs the reference (``repro``) on the CPU on the smoke configs with the
port's numpy weights (``repro_torch.convert.random_model_params``, numpy
only) and chip_smoke.py's numpy inputs (``frontend_ref_inputs``):

- qwen2-vl-7b (f32, 2 layers, M-RoPE sections (8, 12, 12)): 4 prompts of 64
  embeddings whose positions carry one image span (start 8, h 4, w 8), a
  prefill, then 8 greedy decode steps, each fed the text-table row of the
  previous argmax token; the argmax tokens of the prefill and of every step;
- hubert-xlarge (f32, 2 layers): one forward of 4 x 64 frame embeddings; the
  CRC32 of the per-frame argmax codebook ids (int32) and the logits at
  ``AUDIO_REF_SAMPLE``.

Prints ``VLM_REF_TOKENS`` and ``AUDIO_REF_IDS_CRC`` / ``AUDIO_REF_LOGITS`` as
chip_smoke.py holds them, and the seconds each part took on stderr.
"""
import os
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import decode_step, forward, prefill  # noqa: E402
from repro.models.frontends import make_mrope_positions  # noqa: E402
from repro_torch.convert import random_model_params  # noqa: E402


def vlm_tokens():
    """The reference's greedy tokens on ``chip_smoke.VLM_REF``'s inputs:
    a tuple of rows, each prefill's argmax then one a decode step."""
    arch, seed, batch, seq, span, new, max_len = chip_smoke.VLM_REF
    cfg = get_smoke_config(arch)
    params = jax.tree.map(jnp.asarray, random_model_params(cfg, seed))
    embeds, table = chip_smoke.frontend_ref_inputs(
        np, cfg.d_model, cfg.vocab_size, seed, batch, seq)
    pos = make_mrope_positions(batch, seq, span)
    logits, cache = prefill(cfg, params, {"embeds": jnp.asarray(embeds),
                                          "positions": jnp.asarray(pos)},
                            max_len)
    tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
    toks = [tok]
    for _ in range(new):
        logits, cache = decode_step(
            cfg, params, {"embeds": jnp.asarray(table[tok][:, None])}, cache)
        tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        toks.append(tok)
    out = np.stack(toks, axis=1)
    return tuple(tuple(int(t) for t in row) for row in out)


def audio_ref():
    """(CRC32 of the per-frame argmax ids as int32, the logits at
    ``chip_smoke.AUDIO_REF_SAMPLE``) of the reference's forward on
    ``chip_smoke.AUDIO_REF``'s inputs."""
    arch, seed, batch, seq = chip_smoke.AUDIO_REF
    cfg = get_smoke_config(arch)
    params = jax.tree.map(jnp.asarray, random_model_params(cfg, seed))
    embeds, _ = chip_smoke.frontend_ref_inputs(
        np, cfg.d_model, cfg.vocab_size, seed, batch, seq)
    logits, _ = forward(cfg, params, {"embeds": jnp.asarray(embeds)})
    logits = np.asarray(logits)
    ids = logits.argmax(-1).astype(np.int32)
    sample = logits[chip_smoke.AUDIO_REF_SAMPLE]
    return (zlib.crc32(ids.tobytes()),
            tuple(float(x) for x in sample.reshape(-1)))


def main():
    t0 = time.perf_counter()
    tokens = vlm_tokens()
    print(f"vlm: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    crc, sample = audio_ref()
    print(f"audio: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print("VLM_REF_TOKENS = (")
    for row in tokens:
        print(f"    {row},")
    print(")")
    print(f"AUDIO_REF_IDS_CRC = {crc}")
    print("AUDIO_REF_LOGITS = (")
    for i in range(0, len(sample), 3):
        print("    " + " ".join(f"{x!r}," for x in sample[i:i + 3]))
    print(")")


if __name__ == "__main__":
    main()
