from repro_torch.kernels.moe_experts.ops import (moe_dispatch,  # noqa: F401
                                                moe_experts)
