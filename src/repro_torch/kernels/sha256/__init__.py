from repro_torch.kernels.sha256.kernel import chunk_digests  # noqa: F401
