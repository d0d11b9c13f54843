"""Continuous-batching serving of the port: dense, paged and int8-paged
KV, the prefix cache, and int8 weight-only quantization."""

from repro_torch.serving.engine import ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine"]
