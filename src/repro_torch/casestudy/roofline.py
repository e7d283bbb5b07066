"""Roofline over the dry run's records, at an H100's constants.

The twin of the reference's ``benchmarks/roofline.py``.  Per (arch x
shape x mesh) cell, from ``build/dryrun/*.json`` (``launch/dryrun.py``):

  compute_s    = jaxpr_flops_global / (devices * PEAK_FLOPS)
  memory_s     = bytes_min / HBM_BW                           (per device)
  collective_s = collective_bytes_corrected / LINK_BW         (per device)

and the step's bound, ``step_lower_bound_s``, is the largest of the
three.  ``bytes_min`` is what a device's step must move at least
(``launch.dryrun.step_bytes_min``: arguments read once, outputs written
once, a train step's gradients and block-boundary carries written and
read back once).  The dry run's ``bytes_accessed`` is the eager step's
own traffic (every op's operands and results, nothing fused): its time,
``traffic_s``, says how far the eager implementation moves more than it
must, and is not part of the bound.  A record without ``bytes_min`` (the
reference's, whose bytes are XLA's fused HLO's) takes its memory term
from ``bytes_accessed_corrected`` and has no ``traffic_s``.  The port's
dry run counts every loop trip, so its ``*_corrected`` keys equal the
raw ones.

Also: the dominant term, MODEL_FLOPS = 6*N(_active)*D against the counted
FLOPs (the "useful-compute" ratio, catching remat and redundant work),
and a one-line lever per cell.  A record's token count D comes from the
batch, sequence and kind it states (``global_batch``, ``seq_len``,
``kind``), so a cell outside ``configs.SHAPES`` works too; a record
without them (the reference's) is read by its shape's name.

The constants are an H100 SXM's, from NVIDIA's data sheet: 989e12 FLOP/s
dense bf16 on the tensor cores and 3.35e12 B/s of HBM3.  The link term
is the rate a card has to cards of other nodes: one NDR InfiniBand port
of 400 Gb/s, 50e9 B/s.  NVLink gives 450e9 B/s a direction, but only
among the 8 cards of one node; under the meshes' row-major rank order
every axis of both production meshes (16x16 and 2x16x16) spans more than
one 8-card node, so every collective crosses InfiniBand and its slowest
hop sets the term.  ``run`` and ``roofline_row`` take other constants
(``Constants``).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

__all__ = ["Constants", "H100", "PEAK_FLOPS", "HBM_BW", "LINK_BW",
           "NVLINK_BW", "ART_DIR", "load_cells", "tokens", "roofline_row",
           "run", "table", "LEVERS"]

# H100 SXM (NVIDIA data sheet): dense bf16 tensor-core FLOP/s, HBM3 B/s
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# B/s a card sends to another node: one NDR InfiniBand port (400 Gb/s)
LINK_BW = 50e9
# B/s a direction over NVLink 4, to the 7 other cards of its node only
NVLINK_BW = 450e9

ART_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__), "..",
                                        "..", "..", "build", "dryrun"))


@dataclasses.dataclass(frozen=True)
class Constants:
    """A device's peak FLOP/s, memory B/s and link B/s."""
    peak_flops: float
    hbm_bw: float
    link_bw: float


H100 = Constants(PEAK_FLOPS, HBM_BW, LINK_BW)


def load_cells(art_dir: str = ART_DIR) -> list[dict]:
    """Every record of ``art_dir``, by file name."""
    cells = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def tokens(cell: dict) -> int:
    """Tokens of one step of the cell: batch x sequence for a train or
    prefill step, one a lane for a decode step."""
    if "global_batch" in cell:
        batch, seq, kind = (cell["global_batch"], cell["seq_len"],
                            cell["kind"])
    else:
        from repro_torch.configs import SHAPES
        sh = SHAPES[cell["shape"]]
        batch, seq, kind = sh.global_batch, sh.seq_len, sh.kind
    return batch if kind == "decode" else batch * seq


def roofline_row(cell: dict, consts: Constants = H100) -> dict:
    """The cell's three terms, its dominant term and bound, and its
    useful-compute ratio."""
    chips = cell["devices"]
    flops_g = cell.get("jaxpr_flops_global", cell["flops"] * chips)
    compute_s = flops_g / (chips * consts.peak_flops)
    traffic_s = cell.get("bytes_accessed_corrected",
                         cell["bytes_accessed"]) / consts.hbm_bw
    memory_s = (cell["bytes_min"] / consts.hbm_bw if "bytes_min" in cell
                else traffic_s)
    coll_s = cell.get("collective_bytes_corrected",
                      cell["collective_bytes_total"]) / consts.link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    # MODEL_FLOPS: 6*N*D with N = active params (MoE) and D = tokens for a
    # training step (forward and backward); 2*N*D for prefill and decode
    kind = cell.get("kind", "train" if cell["shape"].startswith("train")
                    else "")
    n = cell["params_active"]
    model_flops = (6.0 if kind == "train" else 2.0) * n * tokens(cell)
    useful = model_flops / flops_g if flops_g else 0.0
    bound_s = max(terms.values())
    row = {
        "cell": cell["cell"], "arch": cell["arch"], "shape": cell["shape"],
        "mesh": cell["mesh"], "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_ratio": useful,
        "roofline_fraction": compute_s / bound_s if bound_s else 0.0,
        "step_lower_bound_s": bound_s,
    }
    if "bytes_min" in cell:
        row["traffic_s"] = traffic_s
    return row


LEVERS = {
    "compute": "compute-bound: raise MFU via larger per-chip tiles or fewer "
               "remat recomputes",
    "memory": "memory-bound: fuse converter/elementwise passes, shrink "
              "activation dtype, raise arithmetic intensity per HBM byte",
    "collective": "collective-bound: reshard to cut all-gathers (seq-parallel "
                  "attention / EP all-to-all overlap / int8 cross-pod grads)",
}


def run(art_dir: str = ART_DIR, consts: Constants = H100) -> list[dict]:
    """A row of every record of ``art_dir``, with its lever."""
    rows = [roofline_row(c, consts) for c in load_cells(art_dir)]
    for r in rows:
        r["lever"] = LEVERS[r["dominant"]]
    return rows


def table(rows: list[dict]) -> str:
    hdr = (f"{'cell':58s} {'comp_s':>10s} {'mem_s':>10s} {'coll_s':>10s} "
           f"{'dom':>10s} {'useful':>7s} {'roof%':>6s}")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"{r['cell']:58s} {r['compute_s']:10.3e} {r['memory_s']:10.3e} "
            f"{r['collective_s']:10.3e} {r['dominant']:>10s} "
            f"{r['useful_ratio']:7.3f} {100*r['roofline_fraction']:6.1f}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(table(run()))
