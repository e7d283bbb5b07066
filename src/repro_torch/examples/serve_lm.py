"""Serve a small model with batched requests (continuous batching).

The twin of the reference's ``examples/serve_lm.py``: the smoke
recurrentgemma-9b config (hybrid: RG-LRU blocks and windowed local
attention) serving 10 requests through ``ServingEngine`` with 4 slots of
96 positions, per-lane positions, weights random from seed 0.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine

ARCH = "recurrentgemma-9b"
SLOTS, MAX_LEN, REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 96, 10, 8, 10


def prompts(vocab: int) -> list[list[int]]:
    """The reference's prompts: request ``rid``'s j-th token is
    (rid + 1)(j + 3) mod vocab."""
    return [[((rid + 1) * (j + 3)) % vocab for j in range(PROMPT_LEN)]
            for rid in range(REQUESTS)]


def serve(device: str | torch.device = "cuda", *, cfg=None, params=None
          ) -> tuple[list[Request], float]:
    """The requests served to completion, sorted by id, and the wall.
    ``cfg`` defaults to the smoke config, ``params`` to random weights
    from seed 0 on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card available; pass device='cpu'")
    cfg = cfg or get_smoke_config(ARCH)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            0), device)
    engine = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN)
    t0 = time.time()
    for rid, prompt in enumerate(prompts(cfg.vocab_size)):
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=NEW_TOKENS))
    done = sorted(engine.run_to_completion(), key=lambda r: r.rid)
    return done, time.time() - t0


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    done, dt = serve(args.device)
    for r in done[:5]:
        print(f"rid={r.rid}: {r.prompt[:4]}... -> {r.out_tokens}")
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests / {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s, {SLOTS} slots, per-lane positions)")
    return done


if __name__ == "__main__":
    main()
