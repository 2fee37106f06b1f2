from repro_torch.sharding.rules import (param_specs, batch_specs,  # noqa: F401
                                        cache_specs, opt_state_specs,
                                        constrain, batch_axes)
