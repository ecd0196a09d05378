"""Flat-npz tree checkpointing with step/stage metadata.

The port of ``src/repro/checkpoint/ckpt.py``, in the same layout:
``<dir>/step_<n>.npz`` holds the flattened leaves keyed by their path
string — ``jax.tree_util.keystr``'s rendering, e.g.
``['blocks']['sub0']['attn']['wq']`` (``utils/tree.py``) — plus a JSON
``__meta__`` entry. Types numpy has no form for (bfloat16, float8) are
widened to float32, as the reference widens them. So each package reads
the other's files. Restores into the structure of a template, so shape
drift is caught loudly.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten_with_path

_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype.is_floating_point and t.dtype not in _NUMPY_FLOATS:
        t = t.to(torch.float32)   # bf16 / fp8: widen losslessly
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree, meta: Optional[dict] = None):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:010d}.npz")
    flat = {key: _to_numpy(leaf)
            for key, leaf in tree_flatten_with_path(tree)[0]}
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8).copy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)  # atomic publish
    return path


def _restore(arr: np.ndarray, leaf_t):
    if isinstance(leaf_t, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf_t.device,
                                        dtype=leaf_t.dtype)
    if isinstance(leaf_t, (bool, int, float)):
        return type(leaf_t)(arr)
    return arr


def load_checkpoint(directory: str, template, step: Optional[int] = None
                    ) -> Tuple[Any, dict]:
    """(tree shaped as ``template``, meta). A tensor leaf of the template
    gives a tensor of its type on its device (bf16 cast back from the
    widened float32), a Python scalar a scalar, anything else the array."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}.npz")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        flat, treedef = tree_flatten_with_path(template)
        leaves = []
        for key, leaf_t in flat:
            arr = z[key]
            shape = tuple(getattr(leaf_t, "shape", arr.shape))
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"{shape}")
            leaves.append(_restore(arr, leaf_t))
    return treedef.unflatten(leaves), meta


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None
