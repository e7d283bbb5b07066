"""Time the offload path's flush of two source trees in turns on one CUDA
card, and the sharded flush beside it.

    python3 tools/offload_ab.py --parent DIR [--out FILE] [--flushes N]

DIR is the root of another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into the git-ignored
``build/``.  One worker process per run, in the order parent, this tree,
this tree, parent; each imports its tree's ``repro_torch`` (building that
tree's kernels into that tree's ``build/``) and runs ``chip_smoke.py``
phase 3's flush: 16 frames of 512x512 through
``OffloadExecutor(BATCHED_4F, max_batch=16, pipeline_depth=2)`` on
``optical-sim`` with the L2-derived budget.  It records the host wall of
N flushes after warm-up (submit to the last ``wait()``; the median and
the quartiles) and one flush under torch.profiler (device busy time).
A tree whose executor takes ``n_devices`` runs the same flush through
``n_devices=4, default_backend="sharded"`` in the same worker, in turns
with the unsharded one, and checks it bit-equal to it.

Each worker prints one JSON line; the driver prints them, the medians of
each tree's runs, and writes all of it to FILE (default
``chiprun_out/offload_ab.json``).  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worker(src: str, flushes: int) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch.runtime as rt

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(cs.SEED + 1)
    frames = [cs.rng_frames(rng, (cs.SIDE, cs.SIDE), dev)
              for _ in range(cs.FRAMES)]

    def run(ex):
        t0 = time.perf_counter()
        hs = [ex.submit("fft", x) for x in frames]
        ex.flush_async()
        for h in hs:
            h.wait()
        return (time.perf_counter() - t0) * 1e3, hs

    def stats(walls):
        q = statistics.quantiles(walls, n=4)
        return {"median_ms": statistics.median(walls), "q1_ms": q[0],
                "q3_ms": q[2], "n": len(walls)}

    executors = {"unsharded": rt.OffloadExecutor(
        rt.BATCHED_4F, max_batch=cs.FRAMES, pipeline_depth=2)}
    if hasattr(rt, "ShardedOpticalBackend"):
        executors["sharded"] = rt.OffloadExecutor(
            rt.BATCHED_4F, max_batch=cs.FRAMES, pipeline_depth=2,
            n_devices=4, default_backend="sharded")
    for ex in executors.values():
        ex.warm("fft", frames[0], batch=cs.FRAMES)
        for _ in range(5):
            run(ex)
    torch.cuda.synchronize()
    walls = {name: [] for name in executors}
    values = {}
    for i in range(flushes):
        for name, ex in executors.items():
            wall, hs = run(ex)
            walls[name].append(wall)
            values[name] = [h.value for h in hs]
    if "sharded" in values:
        cs.check(all(torch.equal(a, b) for a, b in
                     zip(values["sharded"], values["unsharded"])),
                 "the sharded flush differs from the unsharded one")
    out = {"src": src, "card": cs.card_line(),
           "tile_k": executors["unsharded"].resolve_tile_k(
               "fft", frames[0], cs.FRAMES)}
    for name, ex in executors.items():
        prof = cs.profile_flush(lambda ex=ex: run(ex)[0], f"{name} flush")
        out[name] = dict(stats(walls[name]), walls_ms=walls[name],
                         device_busy_ms=prof["device_busy_ms"],
                         profiled_wall_ms=prof["wall_ms"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "offload_ab.json"))
    ap.add_argument("--flushes", type=int, default=40)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("AB " + json.dumps(worker(args.worker, args.flushes)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("offload_ab: no CUDA card available", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    trees = {"parent": str(Path(args.parent).resolve() / "src"),
             "change": str(ROOT / "src")}
    runs = []
    for name in ("parent", "change", "change", "parent"):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", trees[name],
             "--flushes", str(args.flushes)],
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the {name} worker failed")
        run = dict(json.loads(lines[0][3:]), tree=name)
        runs.append(run)
        brief = {k: {m: run[k][m] for m in ("median_ms", "q1_ms", "q3_ms",
                                            "device_busy_ms")}
                 for k in ("unsharded", "sharded") if k in run}
        print(f"{name}: tile_k {run['tile_k']}, {json.dumps(brief)}",
              flush=True)
    for name in ("parent", "change"):
        mine = [r for r in runs if r["tree"] == name]
        for path in ("unsharded", "sharded"):
            if path not in mine[0]:
                continue
            print(f"{name} {path} flush: wall medians "
                  f"{[round(r[path]['median_ms'], 4) for r in mine]} ms, "
                  f"device busy "
                  f"{[round(r[path]['device_busy_ms'], 4) for r in mine]}"
                  " ms")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(runs, indent=1))
    print(runs[0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
