"""Continuous-batching serving of the port (dense KV)."""

from repro_torch.serving.engine import ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine"]
