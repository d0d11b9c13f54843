"""Architecture configs (``--arch <id>``) of the ported slice; see
registry.py."""

from repro_torch.configs.registry import LATER, PORTED, get, get_smoke

__all__ = ["LATER", "PORTED", "get", "get_smoke"]
