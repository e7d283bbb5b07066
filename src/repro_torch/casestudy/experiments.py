"""Write EXPERIMENTS.md from the port's own records.

The twin of the reference's ``experiments/gen_experiments.py``.  Run:

    python -m repro_torch.casestudy.experiments [--device cpu]

It reads the dry run's records (``python -m repro_torch.launch.dryrun
--all`` into ``build/dryrun/``, ``--opt`` into ``build/dryrun_opt/``) and
Table 1's rows (``python -m repro_torch.casestudy.run --out build/bench``
writes ``build/bench/amdahl.json``), runs the planner table, Figure 8's
software FFT on the device and Figures 2 and 3, and writes
``build/EXPERIMENTS.md`` (``--out`` overrides it) with these sections:
the dry run (the analytic memory against an H100's 80 GB), the roofline
at an H100's constants (``casestudy.roofline``), the reference's three
hillclimb cells baseline against ``--opt``, Amdahl, the planner, and
Figures 8, 2 and 3.  Every number comes from those records and runs; the
text says only what the numbers show.  A missing record directory or
``amdahl.json`` fails the run (exit 1): nothing is filled in.

It runs Figure 8 on the CUDA card unless ``--device cpu`` is given, and
exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.casestudy.roofline import (ART_DIR, H100, Constants,
                                            load_cells, roofline_row)

__all__ = ["spearman", "gib", "dryrun_section", "roofline_section",
           "perf_section", "amdahl_section", "planner_section",
           "misc_sections", "HILLCLIMB_CELLS", "main"]

BUILD = os.path.dirname(ART_DIR)
OUT = os.path.join(BUILD, "EXPERIMENTS.md")
AMDAHL = os.path.join(BUILD, "bench", "amdahl.json")
# the reference's three hillclimb cells (its OPT_SETTINGS), single pod
HILLCLIMB_CELLS = ("qwen2-72b__train_4k__single",
                   "deepseek-v3-671b__train_4k__single",
                   "nemotron-4-340b__train_4k__single")


def gib(x: float) -> str:
    return f"{x / 2**30:.1f}"


def spearman(a, b) -> float:
    """Spearman's rank correlation (ties ranked by position, as the
    reference ranks them)."""
    def rank(v):
        order = sorted(range(len(v)), key=lambda i: v[i])
        r = [0.0] * len(v)
        for pos, i in enumerate(order):
            r[i] = pos
        return r
    ra, rb = rank(a), rank(b)
    n = len(a)
    d2 = sum((x - y) ** 2 for x, y in zip(ra, rb))
    return 1 - 6 * d2 / (n * (n * n - 1))


def amdahl_section(rows: list[dict]) -> str:
    ours = [r["fraction"] * 100 for r in rows]
    papers = [r["paper_frac"] for r in rows]
    rho = spearman(ours, papers)
    sp = sorted(r["speedup"] for r in rows)
    med, mean = sp[len(sp) // 2], sum(sp) / len(sp)
    n10 = sum(1 for r in rows if r["speedup"] >= 10)
    lines = [
        "## Amdahl: the 27-benchmark case study (paper Table 1 / Fig. 9)",
        "",
        "Each benchmark's FFT/conv share of its wall on the device Table "
        "1's rows were measured on, and the ideal end-to-end speedup it "
        "bounds:",
        "",
        f"* median speedup {med:.2f}x (paper 1.94x), mean {mean:.2f}x "
        "(paper 9.39x)",
        f"* Spearman rank correlation of the FFT/conv fractions with the "
        f"paper's: {rho:.3f}",
        f"* benchmarks at or above the 10x build threshold: "
        f"{n10}/{len(rows)} (paper: 2/27)",
        "",
        "| app | FFT/conv % (ours) | (paper) | speedup (ours) | (paper) |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {100*r['fraction']:.1f} | {r['paper_frac']:.1f}"
            f" | {r['speedup']:.2f} | {r['paper_speedup']:.2f} |")
    return "\n".join(lines)


def dryrun_section(cells: list[dict]) -> str:
    singles = [c for c in cells if c["mesh"] == "single"]
    multis = [c for c in cells if c["mesh"] == "multi"]
    fit = sum(1 for c in cells
              if c["analytic_memory_per_device"]["fits_h100_80gb"])
    lines = [
        "## Dry run: every (arch x shape) on the production meshes",
        "",
        f"{len(cells)} cells counted on `meta`: {len(singles)} on the "
        f"16x16 (256-device) mesh and {len(multis)} on the 2x16x16 "
        "(512-device) mesh.  FLOPs, bytes and collective bytes a device "
        "come from the step run on DTensor trees laid out by the "
        "partition-spec trees; the memory is the analytic residency "
        "model (params, optimizer state, gradients, activations, cache).",
        f"{fit} of {len(cells)} cells fit an H100's 80 GB a device by that "
        "model.  `x split` is a device's FLOPs over the global FLOPs over "
        "the devices: 1 where the step's work splits evenly, more where "
        "the layouts repeat work on several devices.",
        "`counted as` says how a record was counted: `mesh`, the step "
        "partitioned over the whole mesh; `pod slice + cross-pod reduce`, "
        "one pod's step on its 16x16 slice at the pod's half of the batch "
        "plus the gradients' reduction across the pods, a model of the "
        "2x16x16 step, with the microbatches counted / configured.",
        "",
        "| cell | devices | flops/dev | coll bytes/dev | analytic GiB | "
        "fits 80 GB | x split | counted as |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in sorted(cells, key=lambda c: c["cell"]):
        am = c["analytic_memory_per_device"]
        split = c["flops"] * c["devices"] / c["jaxpr_flops_global"]
        lines.append(
            f"| {c['cell']} | {c['devices']} | {c['flops']:.2e} | "
            f"{c['collective_bytes_total']:.2e} | {gib(am['total'])} | "
            f"{'yes' if am['fits_h100_80gb'] else 'no'} | {split:.2f} | "
            f"{counted_as(c)} |")
    return "\n".join(lines)


def counted_as(cell: dict) -> str:
    """How a record was counted (``launch/dryrun.py``): over the whole
    mesh, or one pod's slice plus the cross-pod reduction, with its
    microbatches counted / configured where they differ."""
    how = {"mesh": "mesh", "pod_slice+cross_pod_reduce":
           "pod slice + cross-pod reduce"}.get(cell.get("partition"), "-")
    got, want = cell.get("accum_counted"), cell.get("accum_steps")
    if got is not None and want is not None and got != want:
        how += f", accum {got} / {want}"
    return how


def roofline_section(cells: list[dict], consts: Constants = H100) -> str:
    rows = [roofline_row(c, consts) for c in cells if c["mesh"] == "single"]
    dom = {k: sum(1 for r in rows if r["dominant"] == k)
           for k in ("compute", "memory", "collective")}
    lines = [
        "## Roofline: three terms per cell (16x16, 256 devices)",
        "",
        f"Constants: {consts.peak_flops / 1e12:.0f} TFLOP/s bf16, "
        f"{consts.hbm_bw / 1e9:.0f} GB/s HBM, {consts.link_bw / 1e9:.0f} "
        "GB/s of link a device (an H100 SXM's data sheet; NDR InfiniBand "
        "between nodes).",
        "",
        "compute = global FLOPs / (devices x peak); memory = the bytes "
        "a device's step must move (arguments read once, outputs written "
        "once, a train step's gradients and block-boundary carries "
        "written and read back once) / HBM rate; collective = a device's "
        "collective bytes (max of result and operand of each) / link "
        "rate; the bound is the largest.  `traffic_s` is the eager "
        "step's own traffic (every op's operands and results, unfused) / "
        "HBM rate: what the implementation moves beyond the bound's "
        "memory term, not part of the bound.  Every loop trip is "
        "counted, so no scan correction applies.",
        f"Dominant term: compute in {dom['compute']} cells, memory in "
        f"{dom['memory']}, collective in {dom['collective']}.",
        "",
        "| cell | compute_s | memory_s | collective_s | dominant | "
        "useful(6ND/flops) | roof% | traffic_s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: r["cell"]):
        lines.append(
            f"| {r['cell']} | {r['compute_s']:.2e} | {r['memory_s']:.2e} | "
            f"{r['collective_s']:.2e} | {r['dominant']} | "
            f"{r['useful_ratio']:.2f} | {100*r['roofline_fraction']:.1f} | "
            f"{_traffic(r)} |")
    return "\n".join(lines)


def _traffic(row: dict) -> str:
    return f"{row['traffic_s']:.2e}" if "traffic_s" in row else "-"


def perf_section(base: list[dict], opt: list[dict],
                 consts: Constants = H100) -> str:
    b = {c["cell"]: c for c in base}
    o = {c["cell"]: c for c in opt}
    lines = [
        "## Baseline against `--opt`: the reference's three hillclimb "
        "cells",
        "",
        "`--opt` applies the reference's per-arch settings "
        "(`launch/dryrun.py` OPT_SETTINGS): qwen2-72b sequence-parallel "
        "residual (`sp`), deepseek-v3-671b capacity factor 1.0, "
        "nemotron-4-340b remat groups of 8 with 16 microbatches.",
        "",
        "| cell | variant | compute_s | memory_s | collective_s | "
        "analytic GiB | traffic_s | counted as |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for cell in HILLCLIMB_CELLS:
        for tag, recs in (("baseline", b), ("opt", o)):
            c = recs[cell]
            r = roofline_row(c, consts)
            lines.append(
                f"| {cell} | {tag} | {r['compute_s']:.2e} | "
                f"{r['memory_s']:.2e} | {r['collective_s']:.2e} | "
                f"{gib(c['analytic_memory_per_device']['total'])} | "
                f"{_traffic(r)} | {counted_as(c)} |")
    lines.append("")
    for cell in HILLCLIMB_CELLS:
        rb, ro = roofline_row(b[cell], consts), roofline_row(o[cell], consts)
        moved = ", ".join(
            f"{k} {ro[k + '_s'] / rb[k + '_s']:.2f}x"
            for k in ("compute", "memory", "collective") if rb[k + "_s"])
        lines.append(f"* {cell}: opt / baseline: {moved}; bound "
                     f"{rb['step_lower_bound_s']:.2e} s -> "
                     f"{ro['step_lower_bound_s']:.2e} s")
    return "\n".join(lines)


def planner_section() -> str:
    from repro_torch.casestudy.planner_table import HOST_PEAK, run
    rows = run()
    n_mvm = sum(1 for r in rows if r["mvm_worthwhile"])
    n_4f = sum(1 for r in rows if r["fourier_worthwhile"])
    lines = [
        f"## Planner: the decision rule on the {len(rows)} architectures",
        "",
        "FLOP mix of each smoke config's loss counted on `meta`, host time "
        f"priced at {HOST_PEAK / 1e12:.0f} TFLOP/s (an H100's bf16 peak), "
        "offload priced with on-frontier converter costs.  Worth building "
        f"(>= 10x): the optical MVM engine for {n_mvm} of {len(rows)}, the "
        f"4f accelerator for {n_4f}.",
        "",
        "| arch | matmul flops % | MVM-accel speedup | 4f speedup | "
        ">=10x? | conversion-bound? |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['flops_pct'].get('matmul', 0):.1f} | "
            f"{r['mvm_speedup']:.2f}x | {r['fourier_speedup']:.2f}x | "
            f"{'yes' if r['mvm_worthwhile'] else 'no'} | "
            f"{'yes' if r['mvm_conversion_bound'] else 'no'} |")
    return "\n".join(lines)


def misc_sections(device: torch.device) -> str:
    from repro_torch.casestudy.complexity_fig import run as fig3
    from repro_torch.casestudy.conversion_bottleneck import run as fig8
    from repro_torch.casestudy.pareto import run as fig2
    r8, r2, r3 = fig8(device), fig2(), fig3()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return f"""## Fig. 8: the prototype's data-movement split

The prototype's component model against the software FFT measured on
the device ({name}):

* hardware total {r8['hardware_total_s']:.3f} s (paper 5.209 s), of which
  {r8['hardware_movement_pct']:.3f} % is data movement (paper 99.599 %)
* breakdown: DAC {r8['breakdown']['dac_s']*1e3:.2f} ms, ADC
  {r8['breakdown']['adc_s']*1e3:.2f} ms, interface
  {r8['breakdown']['interface_s']:.3f} s, optics
  {r8['breakdown']['analog_s']*1e3:.1f} ms
* software FFT {r8['software_fft_s']*1e3:.3f} ms: the hardware is
  {r8['hardware_vs_software']:.0f}x slower (paper 23.8x on its host)
* functional simulation's intensity error against the oracle:
  {r8['sim_intensity_rel_err']:.2e}

## Fig. 2: the converter Pareto frontier

* Kim DAC frontier gap {r2['kim_dac_gap']:.2f}x, Liu ADC
  {r2['liu_adc_gap']:.2f}x
* converters a 100,000x MAC-energy claim needs:
  {r2['anderson_dac_gap']:.0f}x / {r2['anderson_adc_gap']:.0f}x below the
  frontier

## Fig. 3: compute against conversion complexity (C = 2N)

Sizes where the compute/conversion advantage first reaches 1x / 10x:

| class | 1x | 10x |
|---|---|---|
""" + "\n".join(
        f"| {k} | {r3['crossover_1x'][k]} | {r3['crossover_10x'][k]} |"
        for k in r3["crossover_1x"]) + "\n"


def _records(path: str) -> list[dict]:
    cells = load_cells(path)
    if not cells:
        raise FileNotFoundError(f"no dry-run records in {path}")
    return cells


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device Fig. 8's FFT runs on (default cuda)")
    ap.add_argument("--dryrun", default=ART_DIR)
    ap.add_argument("--dryrun-opt",
                    default=os.path.join(BUILD, "dryrun_opt"))
    ap.add_argument("--amdahl", default=AMDAHL,
                    help="Table 1's rows (casestudy.run --out DIR)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.casestudy.experiments: no CUDA card available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    try:
        base, opt = _records(args.dryrun), _records(args.dryrun_opt)
        with open(args.amdahl) as f:
            amdahl = json.load(f)
    except FileNotFoundError as e:
        print(f"repro_torch.casestudy.experiments: {e}", file=sys.stderr)
        return 1
    doc = "\n\n".join([
        "# EXPERIMENTS",
        "Regenerate: `python -m repro_torch.launch.dryrun --all` (baseline) "
        "and `--opt`, `python -m repro_torch.casestudy.run --out "
        "build/bench` (Table 1), `python -m "
        "repro_torch.casestudy.experiments` (this file).",
        dryrun_section(base),
        roofline_section(base),
        perf_section(base, opt),
        amdahl_section(amdahl),
        planner_section(),
        misc_sections(device),
    ])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(doc)
    print(f"wrote {args.out} ({len(doc)} chars)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
