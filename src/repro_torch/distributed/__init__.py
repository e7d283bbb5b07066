"""Distributed runtime pieces of the port (so far: straggler deadlines)."""

from repro_torch.distributed.straggler import TrailingMedianDeadline

__all__ = ["TrailingMedianDeadline"]
