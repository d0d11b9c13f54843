"""Hardware models of the port (counterpart of ``repro/core``; only
``hw`` is ported so far)."""
