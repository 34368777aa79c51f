from repro_torch.kernels.scan_mxu import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
