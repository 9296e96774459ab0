from repro_torch.workload.generator import gamma_trace  # noqa: F401
