from repro_torch.serve import engine, step  # noqa: F401
