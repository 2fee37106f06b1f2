from repro_torch.data import pipeline, synthetic, tokens  # noqa: F401
