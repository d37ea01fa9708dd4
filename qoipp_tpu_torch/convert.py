"""Moving codec state between the JAX package and the port.

The codec has no weights; what crosses over is pixel words and the codec
carries: the replay carry of the batch decoder, the decoder's window carry
and the streaming encoder's carry.  The JAX package holds them as uint32
arrays; the port as int32 tensors with the same bits.  Both sides meet as
numpy arrays, so this module needs no JAX.  Like every entry point of the
port, the functions that make tensors put them on the CUDA device unless
the caller passes ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.transfer import fetch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: None means "cuda", which raises
    where there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to stay on "
                           "the host")
    return dev


def words_to_torch(words, device=None) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor, bit for bit."""
    arr = np.array(words, dtype=np.uint32)  # a C-ordered copy, 0-d kept
    return torch.from_numpy(arr.view(np.int32)).to(resolve_device(device))


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array, bit for bit; one
    ``transfer.fetch``."""
    return fetch(t.detach().to(torch.int32).contiguous())[0].view(np.uint32)


def _shaped(name, arr, shape):
    arr = np.asarray(arr)
    if arr.shape != shape:
        raise ValueError(f"{name} has shape {arr.shape}; expected {shape}")
    return arr


def carry_from_jax(prev, seen, device=None):
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


def window_carry_from_jax(prev, seen, device=None):
    """The streaming decoder's window carry — prev (1,) and seen (64,)
    uint32 (the table seeded at slot 53 at stream start) — -> the port's
    int32 tensors of the same shapes."""
    return (words_to_torch(_shaped("prev", prev, (1,)), device),
            words_to_torch(_shaped("seen", seen, (64,)), device))


def window_carry_to_jax(prev: torch.Tensor, seen: torch.Tensor):
    """The port's decoder window carry -> (prev (1,), seen (64,)) uint32."""
    return words_to_numpy(prev), words_to_numpy(seen)


def encoder_carry_from_jax(prev, run, seen, device=None):
    """The streaming encoder's carry — prev and run uint32 scalars (run in
    0..61) and the 64-slot table (64,) uint32, which starts at zero — ->
    the port's int32 tensors prev (), run () and seen (64,)."""
    run = _shaped("run", run, ())
    if not 0 <= int(run) < 62:
        raise ValueError(f"run counter {int(run)} is outside 0..61")
    return (words_to_torch(_shaped("prev", prev, ()), device),
            words_to_torch(run, device),
            words_to_torch(_shaped("seen", seen, (64,)), device))


def encoder_carry_to_jax(prev: torch.Tensor, run: torch.Tensor,
                         seen: torch.Tensor):
    """The port's encoder carry -> (prev, run, seen) uint32 numpy arrays of
    shapes (), () and (64,)."""
    return words_to_numpy(prev), words_to_numpy(run), words_to_numpy(seen)
