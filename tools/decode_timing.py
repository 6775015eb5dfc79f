"""Time llama2-7b's prefill and decode steps on the card, as chip_smoke.py's
[serve] times its teacher-forced kernel run: random bf16 weights drawn on
the card from a seed, 8 prompts of 1024 tokens into a 2048-slot cache,
then 32 decode steps fed given tokens, K2 and K3 on. It times the
``repro_torch`` that ``PYTHONPATH`` names, so one call can time two
checkouts side by side (run them in turn: A, B, B, A):

    PYTHONPATH=<checkout>/src python3 tools/decode_timing.py --rounds 3

Prints one JSON line: the card (``nvidia-smi``'s name and power limit),
the source directory, prefill seconds and decode milliseconds a step for
each round (after one warm-up round)."""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def main() -> int:
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models import transformer as tf

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_timing: no CUDA device")
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = tf.init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                            generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.new),
                           generator=gen, device=dev)
    kcfg = KernelConfig(True)
    pre, dec = [], []
    with torch.no_grad():
        for r in range(args.rounds + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = tf.prefill(cfg, params, {"tokens": prompts},
                                  args.max_len, kcfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(args.new):
                _, cache = tf.decode_step(cfg, params,
                                          {"tokens": tokens[:, i:i + 1]},
                                          cache, kcfg)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if r:  # round 0 warms up
                pre.append(t1 - t0)
                dec.append((t2 - t1) / args.new * 1e3)
            del cache
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": card, "src": repro_torch.__file__,
                      "arch": cfg.name, "prefill_s": pre,
                      "decode_ms_per_step": dec}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
