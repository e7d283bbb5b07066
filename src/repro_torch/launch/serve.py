"""Serving CLI: batched requests through the continuous-batching engine.

Usage (on the CUDA card; ``--device cpu`` for the CPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
      --requests 8 --max-new 12
  PYTHONPATH=src python -m repro_torch.launch.serve --full --max-len 1024

``--full`` serves the architecture's full config instead of its smoke
config.  Weights are random, drawn from ``--seed``; prompts are random
tokens from a numpy generator of the same seed.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as cfgs
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine

__all__ = ["main"]


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=cfgs.TOKEN_ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="the full config, not the smoke config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    args = ap.parse_args(argv)

    get = cfgs.get_config if args.full else cfgs.get_smoke_config
    cfg = get(args.arch)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card available; pass --device cpu")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    engine = ServingEngine(cfg, params, batch_slots=args.slots,
                           max_len=args.max_len)
    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        plen = 8 + (rid % 3) * 4
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new))
    done = engine.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"[serve] rid={r.rid} prompt_len={len(r.prompt)} -> "
              f"{r.out_tokens}")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] {cfg.name} on {where}: {len(done)} requests, {tokens} "
          f"tokens in {dt:.3f} s ({tokens / dt:.1f} tok/s, {args.slots} "
          "slots, continuous batching)")
    return done


if __name__ == "__main__":
    main()
