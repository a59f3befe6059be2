"""Checkpoints in the reference package's format, so either package can
read the other's.

Format: one directory per step, ``step_<n:08d>/arrays.npz`` keyed by the
tree path of every leaf joined with ``\\x1f`` (dict keys, NamedTuple field
names, list indices; ``None`` leaves are absent) plus ``meta.json``.
bfloat16 leaves are stored as the reference stores them: their 16-bit
patterns in a 2-byte void array (``|V2``, which is what numpy writes for an
``ml_dtypes.bfloat16`` array), read back bit for bit; the port has no
ml_dtypes.

Commit protocol: write to ``<dir>/tmp.<step>.<id>``, fsync, atomic rename to
``<dir>/step_<n>``: a crash mid-save never corrupts the latest checkpoint.
Saves can run on a background thread (``async_save``).

A sharded state (each rank's blocks, :func:`repro_torch.train.trainer.
shard_state`) saves as the full arrays: every rank takes part in gathering
them and rank 0 writes.  Restoring with ``shardings`` cuts each rank's
block for the mesh it restores on, which may differ from the one that
saved (an elastic restart).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.distributed import collectives
from repro_torch.tree import tree_leaves_with_path, tree_map, tree_map_with_path

PyTree = Any
_SEP = "\x1f"  # unit separator: safe key joiner


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = np.ascontiguousarray(arr).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {_SEP.join(path): _to_numpy(leaf)
            for path, leaf in tree_leaves_with_path(tree)}


def save(tree: PyTree, ckpt_dir: str, step: int, keep: int = 3,
         async_save: bool = False, extra_meta: Optional[Dict] = None,
         publish: Optional[Callable[[int], None]] = None,
         shardings: Optional[PyTree] = None, mesh=None,
         ) -> Optional[threading.Thread]:
    """Write one checkpoint (see the module docstring for the commit
    protocol).  ``publish(step)``, if given, runs once the step directory is
    durably in place.  Returns the writer thread when ``async_save``.
    With ``shardings`` (a tree of placements on the live ``mesh``) ``tree``
    is this rank's blocks: every rank of the mesh must call, the full
    arrays are gathered, rank 0 writes and the others return None."""
    if shardings is not None:
        tree = tree_map(lambda t, pl: collectives.gather(t, pl, mesh), tree,
                        shardings)
        if dist.get_rank() != 0:
            return None
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)   # device-to-host copies on the caller's thread
    meta = {"step": int(step), **(extra_meta or {})}

    def _write():
        tmp = os.path.join(ckpt_dir, f"tmp.{step}.{uuid.uuid4().hex[:8]}")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        dfd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        if os.path.exists(final):
            shutil.rmtree(final, ignore_errors=True)
        try:
            os.rename(tmp, final)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # concurrent writer won
        _gc(ckpt_dir, keep)
        if publish is not None:
            publish(int(step))

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(template: PyTree, ckpt_dir: str, step: Optional[int] = None,
            shardings: Optional[PyTree] = None, mesh=None) -> PyTree:
    """Restore into the structure, dtypes and devices of ``template``.
    With ``shardings`` (a tree of placements on the live ``mesh``, which
    need not be the mesh that saved) each leaf comes back as this rank's
    block, and ``template`` holds those blocks' shapes."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def load(path, node):
        key = _SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key!r}")
        arr = flat[key]
        pl = placement.get(path)
        shape = tuple(arr.shape) if pl is None else \
            pl.local_shape(arr.shape)
        if shape != tuple(node.shape):
            raise ValueError(f"{key}: ckpt shape {arr.shape} (this rank's "
                             f"block {shape}) != {tuple(node.shape)}")
        if pl is None:
            return _from_numpy(arr, node)
        return collectives.shard(_from_numpy(arr, node), pl, mesh)
    placement = dict(tree_leaves_with_path(shardings)) \
        if shardings is not None else {}
    return tree_map_with_path(load, template)


def load_meta(ckpt_dir: str, step: int) -> Dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)
