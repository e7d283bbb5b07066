"""Computational vs conversion complexity (paper §4, Fig. 3).

The paper's rule: an analog accelerator is only worth feeding when the
computational complexity of the offloaded op dominates the conversion
complexity C = 2N of moving its operands across the digital/analog boundary.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["PROBLEM_CLASSES", "crossover_n", "advantage"]


# name -> f(N) compute cost (abstract op counts), as plotted in Fig. 3.
PROBLEM_CLASSES: dict[str, Callable[[float], float]] = {
    "elementwise O(N)": lambda n: n,
    "fft O(N log N)": lambda n: n * max(math.log2(n), 1.0),
    "matvec O(N^2)": lambda n: n ** 2,
    "matmul O(N^3)": lambda n: n ** 3,
    "ising O(2^N)": lambda n: 2.0 ** min(n, 1000.0),  # capped: float overflow
}


def conversion_cost(n: float) -> float:
    """C = 2N: DAC in + ADC out for every datum."""
    return 2.0 * n


def advantage(problem: str, n: float) -> float:
    """compute_cost / conversion_cost — how much headroom offload has."""
    if problem not in PROBLEM_CLASSES:
        raise KeyError(f"unknown problem class {problem!r}")
    if n <= 0:
        raise ValueError("n must be positive")
    return PROBLEM_CLASSES[problem](n) / conversion_cost(n)


def crossover_n(problem: str, threshold: float = 1.0,
                n_max: float = 2.0 ** 40) -> float | None:
    """Smallest N (power of two) where compute/conversion >= threshold.

    Returns None when the class never crosses (e.g. O(N) is pinned at 0.5x:
    such accelerators are *always* conversion-bound — the paper's point).
    """
    n = 1.0
    while n <= n_max:
        if advantage(problem, n) >= threshold:
            return n
        n *= 2.0
    return None
