"""Parameter trees between the reference package and the port.

The reference hands its tree over as nested dicts of numpy arrays (the
caller does the ``jax -> numpy`` step; this module never imports jax).  Both
packages keep the same layout (nested dicts, scan-stacked ``(L, ...)``
leaves, the hybrid's list of per-layer dicts with its 0-d markers), so the
conversion is leaf by leaf over :mod:`repro_torch.tree`.  ``None`` leaves
stay ``None`` and NamedTuples keep their type, so a whole train state
crosses (:func:`repro_torch.train.trainer.train_state_from_numpy` rebuilds
the port's own ``TrainState`` from the reference's).

A bfloat16 leaf arrives as an ``ml_dtypes.bfloat16`` numpy array, which
``torch.from_numpy`` rejects: its dtype is recognised by name and its bits
are reinterpreted as int16, then viewed as ``torch.bfloat16``; the way back
reverses that.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _to_numpy(t: torch.Tensor, bf16_dtype) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits if bf16_dtype is None else bits.view(bf16_dtype)
    return t.numpy()


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts / lists / NamedTuples of numpy arrays (0-d ones
    included) -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def params_to_numpy(tree: Any, bf16_dtype: Optional[Any] = None) -> Any:
    """The port's tree -> nested dicts of numpy arrays.  bfloat16 leaves come
    back as their uint16 bit patterns, viewed as ``bf16_dtype`` when the
    caller passes a numpy bfloat16 dtype (e.g. the reference's)."""
    return tree_map(lambda t: _to_numpy(t, bf16_dtype), tree)
