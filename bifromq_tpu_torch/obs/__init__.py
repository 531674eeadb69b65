"""Observability primitives of the port (only ``window``'s log2 bucket
discipline so far; the ``OBS`` hub and its probes are ROADMAP A.10)."""
