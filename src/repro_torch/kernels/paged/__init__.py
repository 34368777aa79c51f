from repro_torch.kernels.paged import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
