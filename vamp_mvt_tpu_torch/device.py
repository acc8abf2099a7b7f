"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller names another device.  With no
device given and no GPU present they raise: the port never carries on on the
CPU by itself.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda")
