from repro_torch.models import layers, transformer  # noqa: F401
