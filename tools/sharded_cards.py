"""Drive the sharded offload runtime across several CUDA cards.

    python3 tools/sharded_cards.py [--out FILE]

Needs at least four cards (exits with code 2 otherwise).  With four,
``distributed.sharding.shard_devices(4, cuda:0)`` hands the sharded
backend one card per shard, so this runs the placed route that a
one-card machine never reaches: each shard's frames copied to its card,
the kernel/weights, DFT factors and Fourier masks made there, the DFT
kernels launched there, the outputs gathered back to ``cuda:0``.

It builds the kernels, runs ``chip_smoke.py`` phase 3's flush unsharded
on ``cuda:0`` (the reference values), then ``chip_smoke.py`` phase 8
unchanged (the sharded flush bit-equal to the unsharded one with every
DFT launch on the tensor-core route, the frame-sharded conv, the chaos
run, the traced flush), and then the placement lifecycle with a
residency cache: commit, a repeat flush served from the cards' resident
sets, a lost device quarantined and its placement dropped, the rebuild
on the survivors, every flush bit-equal to the unsharded one.  Prints
the card line and writes the results to FILE (default
``chiprun_out/sharded_cards.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def lifecycle(rt, frames, want) -> dict:
    """Tiles of 4 frames, one per card, and a residency cache of 1 GiB
    (the L2-derived budget's share holds too few 512x512 frames, and the
    tile depth would shrink as the cache fills); under a ManualClock, so
    that the lost device stays quarantined until the rebuild, however
    slow the host."""
    import torch
    ex = rt.OffloadExecutor(rt.BATCHED_4F, max_batch=len(frames),
                            pipeline_depth=2, n_devices=4, tile_k=4,
                            default_backend="sharded",
                            residency=rt.ResidencyCache(
                                capacity_bytes=1 << 30),
                            clock=rt.ManualClock())
    be = ex._backend("sharded")

    def flush(what):
        t0 = time.perf_counter()
        hs = [ex.submit("fft", x) for x in frames]
        ex.flush()
        wall = (time.perf_counter() - t0) * 1e3
        for i, (h, w) in enumerate(zip(hs, want)):
            if not torch.equal(h.value, w):
                raise RuntimeError(f"{what}, frame {i}: differs from the "
                                   "unsharded flush")
        return wall

    walls = {"commit": flush("commit")}
    (pl,) = be._placements.values()
    cards = sorted({str(d) for d in pl.devices})
    walls["resident"] = flush("resident repeat")
    hits = dict(ex.telemetry.residency_counts["fft"])
    ex.ctx.lost_devices = frozenset({1})
    walls["device_loss"] = flush("device loss")
    ex.ctx.lost_devices = frozenset()
    dropped = not be._placements
    quarantined = ex.quarantine.is_quarantined(("device", 1), ex.now())
    walls["rebuild"] = flush("rebuild")
    (pl2,) = be._placements.values()
    out = {"pool": pl.pool, "cards": cards, "residency": hits,
           "dropped_on_loss": dropped, "quarantined": quarantined,
           "rebuilt_pool": pl2.pool, "walls_ms": walls}
    print(f"  placement lifecycle: pool {pl.pool} on {cards}; residency "
          f"{hits}; device 1 lost -> quarantined {quarantined}, placement "
          f"dropped {dropped}; rebuilt on {pl2.pool}; walls {walls} ms")
    if not (dropped and quarantined and pl2.pool == [0, 2, 3]
            and hits.get("hit", 0) >= len(frames) and len(cards) == 4):
        raise RuntimeError(f"placement lifecycle: {out}")
    ex.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "sharded_cards.json"))
    args = ap.parse_args()
    import torch
    if torch.cuda.device_count() < 4:
        print("sharded_cards: needs four CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    import repro_torch.runtime as rt
    from repro_torch.kernels import build
    from repro_torch.kernels import optical_dft as od

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, f"x{torch.cuda.device_count()}")
    build.build_all()
    print("the offload flush, unsharded on cuda:0")
    main_run = cs.phase_main_path(rt, od, dev)
    frames, want = main_run["_frames"], main_run["_values"]
    print("phase 8 across the cards")
    sharded = cs.phase_sharded(rt, od, dev, main_run, card)
    if not sharded["flush"]["placed"]:
        raise RuntimeError("phase 8 did not take the placed route")
    print("placements with a residency cache")
    sharded["lifecycle"] = lifecycle(rt, frames, want)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"cards": torch.cuda.device_count(), "sharded": sharded,
         "unsharded_flush": {k: v for k, v in main_run.items()
                             if not k.startswith("_")}}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
