from repro_torch.kernels.mamba_scan.ops import selective_scan  # noqa: F401
