from repro_torch.kernels.scan_tile import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
