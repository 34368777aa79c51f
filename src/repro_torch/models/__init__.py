"""Model building blocks of the port (``repro/models``): attention-only
decoder stacks over a parameter tree of tensors stacked along the period
axis, the reference's own layout."""
