"""Model building blocks of the port (``repro/models``): decoder stacks of
attention, MoE and Mamba layers (and the encoder of an encoder–decoder)
over a parameter tree of tensors stacked along the period axis, the
reference's own layout."""
