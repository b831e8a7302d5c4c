from repro_torch.kernels.ssd_scan.ops import ssd_chunked  # noqa: F401
