"""Figure 3 reproduction: computational vs conversion complexity C = 2N.

The twin of the reference's ``benchmarks/complexity_fig.py``: tabulates
the compute/conversion advantage for each problem class across problem
sizes and the crossover size where offload first pays (threshold 1x and
the paper's 10x build-bar).
"""

from __future__ import annotations

from repro_torch.core.complexity import PROBLEM_CLASSES, advantage, crossover_n

__all__ = ["run"]


def run() -> dict:
    sizes = [2 ** k for k in range(2, 21, 3)]
    table = {name: [advantage(name, n) for n in sizes]
             for name in PROBLEM_CLASSES}
    return {
        "sizes": sizes,
        "advantage": table,
        "crossover_1x": {n: crossover_n(n, 1.0) for n in PROBLEM_CLASSES},
        "crossover_10x": {n: crossover_n(n, 10.0) for n in PROBLEM_CLASSES},
    }
