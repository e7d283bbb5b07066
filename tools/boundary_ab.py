"""Time kernel 5 (the converter boundary) and DFT stage 1 of two source
trees in turns on one CUDA card.

    python3 tools/boundary_ab.py --parent DIR [--out FILE]

DIR is the root of another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into the git-ignored
``build/``.  One worker process per run, in the order parent, this tree,
this tree, parent; each imports its tree's ``repro_torch`` (building that
tree's kernels into that tree's ``build/``) and times, with
``chip_smoke.py``'s profiler helpers:

* ``ops.converter_boundary`` at ``chip_smoke.py``'s four cases (2048x2048
  float32 and 4096x2048 bfloat16, with float32 noise and without): the
  kernels' own time per call under torch.profiler (``kernel_ms``), and
  the device time per call from CUDA events with the card held busy
  while the host queues (``held_ms``: from the end of the work before to
  the end of the call, so launch gaps count), each back to back and with
  L2 cleared before each call (a 256 MiB buffer read), the events also
  after a dirty flush (the buffer rewritten); the launch API calls a call
  makes and the CUDA-event wall of a call;
* ``ops.dft_stage1_batched`` at (b, 512, 512, 512), 8-bit DAC, b = 1, 2
  and 16: device time per call under torch.profiler, as phase 4 takes
  it.

Each worker prints one JSON line; the driver prints them, the mean of each
tree's two runs, and writes all of it to FILE (default
``chiprun_out/boundary_ab.json``).  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STAGE1_BATCHES = (1, 2, 16)


def worker(src: str) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import optical_dft as od

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"src": src, "card": cs.card_line(), "boundary": [], "stage1": []}
    kw = dict(dac_bits=8, adc_bits=8, noise_std=cs.BOUNDARY_NOISE_STD)
    for x, nz in cs.boundary_inputs(dev):
        call = lambda: ops.converter_boundary(x, nz, **kw)
        kernel_ms, _, api = cs.device_profile(call)
        out["boundary"].append({
            "shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
            "noise": nz is not None, "kernel_ms": kernel_ms,
            "kernel_l2_cleared_ms": cs.device_profile(
                call, flush=scratch.amax)[0],
            "ms": cs.held_ms(call),
            "l2_cleared_ms": cs.held_ms(call, flush=scratch.amax),
            "l2_dirty_ms": cs.held_ms(call, flush=scratch.bitwise_not_),
            "launch_calls": api, "wall_ms": cs.median_ms(call)})
    rng = np.random.default_rng(cs.SEED + 3)
    wr, wi = od.dft_matrix_factors(cs.SIDE, device=dev)
    for b in STAGE1_BATCHES:
        a = cs.rng_frames(rng, (b, cs.SIDE, cs.SIDE), dev)
        out["stage1"].append({"batch": b, "ms": cs.device_ms(
            lambda: ops.dft_stage1_batched(wr, wi, a, dac_bits=8))[0]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "boundary_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("AB " + json.dumps(worker(args.worker)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("boundary_ab: no CUDA card available", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    trees = {"parent": str(Path(args.parent).resolve() / "src"),
             "change": str(ROOT / "src")}
    runs = []
    for name in ("parent", "change", "change", "parent"):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", trees[name]],
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the {name} worker failed")
        run = dict(json.loads(lines[0][3:]), tree=name)
        runs.append(run)
        print(f"{name}: {json.dumps(run)}", flush=True)
    for name in ("parent", "change"):
        mine = [r for r in runs if r["tree"] == name]
        for i, case in enumerate(mine[0]["boundary"]):
            vals = {k: [r["boundary"][i][k] for r in mine]
                    for k in ("kernel_ms", "kernel_l2_cleared_ms", "ms",
                              "l2_cleared_ms", "l2_dirty_ms", "wall_ms")}
            print(f"{name} converter_boundary {case['shape']} "
                  f"{case['dtype']} noise {case['noise']}: kernels "
                  f"{vals['kernel_ms']} ms back to back, "
                  f"{vals['kernel_l2_cleared_ms']} ms L2 cleared; held "
                  f"events {vals['ms']} ms back to back, "
                  f"{vals['l2_cleared_ms']} ms L2 cleared, "
                  f"{vals['l2_dirty_ms']} ms after a dirty flush; wall "
                  f"{vals['wall_ms']} ms; launches a call "
                  f"{case['launch_calls']}")
        for i, b in enumerate(STAGE1_BATCHES):
            vals = [r["stage1"][i]["ms"] for r in mine]
            print(f"{name} dft_stage1_batched ({b}, 512, 512, 512): device "
                  f"{vals} ms")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(runs, indent=1))
    print(runs[0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
