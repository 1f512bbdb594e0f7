"""The stream dimension of the device program.

Every op of the device program takes a leading stream dimension (S frames,
lattices or fields at once); the single-stream form is its S = 1 case. These
helpers move between the two on the results, which are tensors, tuples of
them, or dataclasses of them (possibly nested, possibly with ``None``
leaves).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


def map_tensors(fn: Callable[[Any], Any], obj):
    """``fn`` on every tensor (or numpy array) leaf of a result; None stays."""
    if obj is None:
        return None
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, x) for x in obj)
    return dataclasses.replace(obj, **{
        f.name: map_tensors(fn, getattr(obj, f.name))
        for f in dataclasses.fields(obj)})


def stream(obj, s: int):
    """Stream ``s`` of a batched result: every leaf loses its first dimension."""
    return map_tensors(lambda x: x[s], obj)


def to_numpy(obj):
    """A result with numpy leaves, each tensor copied to the host."""
    return map_tensors(lambda x: x.cpu().numpy(), obj)
