from repro_torch.kernels.flatten import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
