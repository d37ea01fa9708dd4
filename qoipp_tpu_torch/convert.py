"""Moving codec state between the JAX package and the port.

The codec has no weights; what crosses over is pixel words and the replay
carry.  The JAX package holds them as uint32 arrays; the port as int32
tensors with the same bits.  Both sides meet as numpy arrays, so this
module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def words_to_torch(words, device="cpu") -> torch.Tensor:
    """uint32 numpy array -> int32 tensor, bit for bit."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array, bit for bit."""
    return t.detach().to("cpu", torch.int32).contiguous().numpy().view(np.uint32)


def carry_from_jax(prev, seen, device="cpu"):
    """A JAX replay carry — prev (1, B) and seen (64, B) uint32, as numpy —
    -> the port's (prev, seen) int32 tensors for replay_batch_carry."""
    prev, seen = np.asarray(prev), np.asarray(seen)
    b = prev.shape[-1]
    if prev.shape != (1, b) or seen.shape != (64, b):
        raise ValueError(f"carry shapes {prev.shape}, {seen.shape}; "
                         "expected (1, B), (64, B)")
    return words_to_torch(prev, device), words_to_torch(seen, device)


def carry_to_jax(prev: torch.Tensor, seen: torch.Tensor):
    """The port's replay carry -> (prev (1, B), seen (64, B)) uint32 numpy
    arrays, which jax.numpy.asarray takes as they are."""
    return words_to_numpy(prev), words_to_numpy(seen)
