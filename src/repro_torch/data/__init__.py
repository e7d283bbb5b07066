"""Data pipeline: deterministic, resumable synthetic sources."""

from repro_torch.data.pipeline import MarkovTask, SyntheticTask

__all__ = ["SyntheticTask", "MarkovTask"]
