"""Distributed runtime pieces of the port (so far: straggler deadlines and
the fault-tolerant training runner, ``distributed.fault``)."""

from repro_torch.distributed.straggler import TrailingMedianDeadline

__all__ = ["TrailingMedianDeadline"]
