"""Device selection for the port's entry points.

Every entry point (`Engine`, `init_params`, `params_from_jax`, `KVCache.zeros`)
runs on the card unless the caller asks for the CPU, as the tests do. Asking
for CUDA where there is none is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return device
