"""Batched serving runtime (continuous batching over fixed cache slots)."""

from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
