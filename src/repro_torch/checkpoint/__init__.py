from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, load_flat, restore_checkpoint, save_checkpoint)
