"""Twins of the reference's ``examples/`` scripts, on the port:
``python -m repro_torch.examples.<name> [--device cpu]`` for ``quickstart``,
``two_phase``, ``moe_dispatch``, ``serve_batched`` and ``train_lm``.  Each
prints what the original prints and asserts what it asserts; importing one
runs nothing.  They run on the card unless given ``--device cpu``."""
