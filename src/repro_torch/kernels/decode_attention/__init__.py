from repro_torch.kernels.decode_attention import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
