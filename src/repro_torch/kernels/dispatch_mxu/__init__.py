from repro_torch.kernels.dispatch_mxu import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
