"""The case study's entry point: one section per paper table/figure.

    python -m repro_torch.casestudy.run [--device cpu] [--out DIR]

Prints ``section,name,us_per_call,derived`` CSV rows, as the reference's
``benchmarks/run.py`` does for the same sections:

  * Table 1 / Fig 9: us_per_call = the benchmark's total time over its
    timed repeats, derived = the ideal end-to-end Amdahl speedup and the
    FFT/conv fraction, the paper's values beside them; then MEDIAN and
    MEAN;
  * Fig 8: the software FFT's time on the device against the modelled
    prototype;
  * Fig 2: converter frontier gaps; Fig 3: complexity crossovers;
  * the planner: the paper's decision rule on each of the ten LM
    architectures (``planner_table``), host seconds priced at the H100's
    bf16 peak;
  * the offload runtime's benchmark (``runtime_bench``): its CSV rows and
    the ``drift_gate`` row.  It writes its snapshot and history under
    ``--out`` (default ``build/bench/``), and Table 1's rows there as
    ``amdahl.json`` (what ``casestudy.experiments`` reads);
  * the roofline (``casestudy.roofline``, an H100's constants) of each
    dry-run record in ``build/dryrun/`` and ``build/dryrun_opt/``
    (``roofline`` and ``roofline_opt`` rows), where the dry run has
    written them: us_per_call = the step's lower bound.

The first row after the header names the device the times were taken
on.  It runs on the CUDA card unless ``--device cpu`` is given, and
fails without a card: there is no fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.casestudy import runtime_bench as rb


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--out", default=rb.OUT_DIR,
                    help="directory of the runtime bench's snapshot and "
                         f"history (default: {rb.OUT_DIR})")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.casestudy.run: no CUDA card available (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        return 2

    print("section,name,us_per_call,derived")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device,{name},,")

    # --- Table 1 / Figure 9: the 27-benchmark Amdahl suite ------------------
    from repro_torch.casestudy.amdahl_suite import PAPER_TABLE1, run_suite
    rows = run_suite(device=device)
    speedups = []
    for r in rows:
        paper_pct, paper_s = PAPER_TABLE1[r.name]
        speedups.append(r.end_to_end_speedup)
        print(f"table1,{r.name},{1e6 * r.total_time_s:.1f},"
              f"speedup={r.end_to_end_speedup:.2f}x|frac={100*r.fraction:.2f}%"
              f"|paper={paper_s:.2f}x|paper_frac={paper_pct:.2f}%")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "amdahl.json"), "w") as f:
        json.dump([{"name": r.name, "fraction": r.fraction,
                    "speedup": r.end_to_end_speedup,
                    "total_time_s": r.total_time_s,
                    "paper_frac": PAPER_TABLE1[r.name][0],
                    "paper_speedup": PAPER_TABLE1[r.name][1]}
                   for r in rows], f, indent=1)
    ss = sorted(speedups)
    median = ss[len(ss) // 2]
    mean = sum(ss) / len(ss)
    print(f"table1,MEDIAN,,{median:.2f}x (paper 1.94x)")
    print(f"table1,MEAN,,{mean:.2f}x (paper 9.39x)")

    # --- Figure 8: prototype data-movement split ------------------------------
    from repro_torch.casestudy.conversion_bottleneck import run as fig8
    r8 = fig8(device)
    print(f"fig8,software_fft,{1e6 * r8['software_fft_s']:.1f},measured")
    print(f"fig8,hardware_total,{1e6 * r8['hardware_total_s']:.1f},"
          f"movement={r8['hardware_movement_pct']:.3f}% (paper "
          f"{r8['paper_movement_pct']}%)")
    print(f"fig8,slowdown,,{r8['hardware_vs_software']:.1f}x slower than "
          f"software (paper {r8['paper_hardware_vs_software']:.1f}x on rpi4)")
    print(f"fig8,sim_intensity_rel_err,,{r8['sim_intensity_rel_err']:.2e}")

    # --- Figure 2: converter Pareto frontier ------------------------------------
    from repro_torch.casestudy.pareto import run as fig2
    r2 = fig2()
    for k in ("kim_dac_gap", "liu_adc_gap", "anderson_dac_gap",
              "anderson_adc_gap"):
        print(f"fig2,{k},,{r2[k]:.2f}x")

    # --- Figure 3: complexity crossover -------------------------------------------
    from repro_torch.casestudy.complexity_fig import run as fig3
    r3 = fig3()
    for name, n in r3["crossover_1x"].items():
        n10 = r3["crossover_10x"][name]
        print(f"fig3,{name.replace(' ', '_')},,"
              f"crossover_1x=N{n}|crossover_10x=N{n10}")

    # --- Planner: the ported archs under the decision rule -----------------------
    from repro_torch.casestudy.planner_table import run as planner
    for row in planner():
        mm = row["flops_pct"].get("matmul", 0.0)
        print(f"planner,{row['arch']},,mvm={row['mvm_speedup']:.2f}x"
              f"|fourier={row['fourier_speedup']:.2f}x"
              f"|matmul_flops={mm:.1f}%"
              f"|worthwhile={row['mvm_worthwhile']}"
              f"|conversion_bound={row['mvm_conversion_bound']}")

    # --- Offload runtime: batching amortization + telemetry round trip ------
    # write_json also appends the record to the bench's history, which the
    # drift gate's history band reads (loaded before this run appends).
    history = rb.load_history(os.path.join(args.out, rb.HISTORY))
    payload = rb.write_json(device, args.out)
    for row in rb.run(payload):
        print(row)
    ok, msg = rb.drift_gate(payload["traced"]["drift"], history)
    print(f"drift_gate,{'ok' if ok else 'FAIL'},,{msg}")

    # --- Roofline of the dry run's records, where they have been written --
    from repro_torch.casestudy.roofline import ART_DIR, run as roofline
    for tag, d in (("roofline", ART_DIR),
                   ("roofline_opt", os.path.join(os.path.dirname(ART_DIR),
                                                 "dryrun_opt"))):
        for r in roofline(d):
            print(f"{tag},{r['cell']},{1e6 * r['step_lower_bound_s']:.1f},"
                  f"dominant={r['dominant']}|useful={r['useful_ratio']:.3f}"
                  f"|roof={100*r['roofline_fraction']:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
