from repro_torch.kernels.rglru.ops import linear_scan
