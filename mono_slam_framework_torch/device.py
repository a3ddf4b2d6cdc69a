"""Device selection for the port's entry points.

The entry points (the matcher, `System`, `convert`) run on the card unless
the caller asks for the CPU. Asking for a CUDA device where there is none
raises here, at construction, rather than at the first tensor moved.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and no card is
    available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but no CUDA card is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
