"""Deterministic, resumable data pipeline.

Batches are pure functions of ``(seed, step)``: each step seeds its own
``torch.Generator`` from the pair, so the pipeline's whole checkpointable
state is one integer, and a restart re-produces bit-identical batches with
no data-loader state files.  The draws are torch's, not ``jax.random``'s,
so the two packages give different batches from one seed; parity tests
hand both the same tokens.  ``make_batch_sharding`` gives the batch's
layout on a device mesh, as ``(mesh, placements)``.

Two sources:
  * ``SyntheticTask``  — uniform random tokens (shape/throughput testing).
  * ``MarkovTask``     — an order-1 Markov chain with low-entropy rows; a
    model that learns must drive CE below the unigram entropy, so training
    shows real loss curves.  Its transition table is the reference's, bit
    for bit (the same ``np.random.default_rng(seed)`` draws).

Batches are built on the host and moved to ``device`` once per step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SyntheticTask", "MarkovTask", "make_batch_sharding"]


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator keyed by (seed, step), the counterpart of the
    reference's ``fold_in(PRNGKey(seed), step)``."""
    if not 0 <= seed < 1 << 31 or not 0 <= step < 1 << 32:
        raise ValueError(f"seed {seed} / step {step} out of range")
    return torch.Generator().manual_seed((seed << 32) | step)


def _split(toks: torch.Tensor, device) -> dict[str, torch.Tensor]:
    toks = toks.to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class SyntheticTask:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int, device: str | torch.device = "cuda"
              ) -> dict[str, torch.Tensor]:
        toks = torch.randint(0, self.vocab_size,
                             (self.global_batch, self.seq_len + 1),
                             generator=_generator(self.seed, step))
        return _split(toks, device)


@dataclasses.dataclass(frozen=True)
class MarkovTask:
    """Order-1 Markov chain over the vocab; rows concentrate on ~8 tokens."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8

    def _transitions(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        nxt = rng.integers(0, self.vocab_size,
                           size=(self.vocab_size, self.branching))
        return nxt.astype(np.int32)

    def batch(self, step: int, device: str | torch.device = "cuda"
              ) -> dict[str, torch.Tensor]:
        nxt = self._transitions()
        gen = _generator(self.seed + 1, step)
        state = torch.randint(0, self.vocab_size, (self.global_batch,),
                              generator=gen).numpy()
        choices = torch.randint(0, self.branching,
                                (self.global_batch, self.seq_len),
                                generator=gen).numpy()
        toks = np.empty((self.global_batch, self.seq_len + 1), np.int64)
        toks[:, 0] = state
        for t in range(self.seq_len):      # the walk is sequential
            toks[:, t + 1] = nxt[toks[:, t], choices[:, t]]
        return _split(torch.from_numpy(toks), device)

    @property
    def entropy_floor_nats(self) -> float:
        """CE floor for a perfect model: log(branching) (uniform choices)."""
        return float(np.log(self.branching))


def make_batch_sharding(mesh) -> tuple:
    """(mesh, placements) of a batch whose dim 0 is sharded over every
    data-like mesh axis (``pod`` and ``data``), the rest replicated."""
    from repro_torch.distributed.sharding import placements
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return mesh, placements((axes if axes else None,), mesh)
