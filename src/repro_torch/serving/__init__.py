"""Serving of the port (``repro.serving``): KV-cache policies, prefill and
decode steps, the admission scheduler, ``Engine`` and ``BatchEngine``."""
