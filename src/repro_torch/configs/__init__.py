"""Architecture configs (``--arch <id>``) of the port; see registry.py."""

from repro_torch.configs.registry import PORTED, get, get_smoke

__all__ = ["PORTED", "get", "get_smoke"]
