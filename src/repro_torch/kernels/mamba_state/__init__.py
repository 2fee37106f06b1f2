from repro_torch.kernels.mamba_state.ops import mamba_state  # noqa: F401
