from repro_torch.optim.adamw import adamw  # noqa: F401
from repro_torch.optim.sgd import sgd  # noqa: F401
from repro_torch.optim import schedules  # noqa: F401
