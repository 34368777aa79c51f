from repro_torch.kernels.push_back import kernel, ops, ref  # noqa: F401
