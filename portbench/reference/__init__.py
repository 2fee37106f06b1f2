"""The plain reference: the served model's forward pass in float32 (and
its lower-precision control), plain PyTorch, importing nothing of the
program."""
