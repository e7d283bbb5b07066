"""Device placement for sharded offload dispatch.

Only :func:`shard_devices` so far: the reference's mesh and partition
specs (``repro.distributed.sharding``) are a later slice of the port.
"""

from __future__ import annotations

import torch

__all__ = ["shard_devices"]


def shard_devices(n: int, home: torch.device) -> list[torch.device] | None:
    """Pick ``n`` distinct devices to scatter work shards onto.

    When ``home`` (the executor's device) is a CUDA card and the machine
    has at least ``n`` cards, the shards go to ``cuda:0 .. cuda:n-1``.
    Otherwise — one card, or the CPU — this returns None: the caller's cue
    to take the sequential fallback, where the shards dispatch in turn on
    ``home`` with identical numerics (the reference's off-mesh fallback).
    """
    if n <= 1 or home.type != "cuda" or torch.cuda.device_count() < n:
        return None
    return [torch.device("cuda", i) for i in range(n)]
