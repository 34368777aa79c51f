"""Serving of the port (``repro.serving``): KV-cache policies, prefill and
decode steps, the admission scheduler, the prefix cache, ``Engine`` and
``BatchEngine``."""
