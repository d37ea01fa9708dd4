"""Host-to-device uploads of the engines' staged plans.

Every ``stage_plan`` moves its numpy plan to the device through ``upload``:
on a CUDA device by way of pinned host memory and a ``non_blocking`` copy,
so the host goes on planning while the copy runs and the copy overlaps
what the card is computing.  PyTorch's caching host allocator records the
copy's stream against the pinned block and hands the block out again only
after the copy has finished, so the pinned tensor may be dropped once the
copy is issued.  On the CPU the array is wrapped without a copy.
"""

from __future__ import annotations

import numpy as np
import torch


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, copied asynchronously from
    pinned memory where the device is a card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
