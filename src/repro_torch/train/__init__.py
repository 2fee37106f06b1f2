from repro_torch.train import losses, step, trainer  # noqa: F401
