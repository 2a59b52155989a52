"""Checkpoints: flat-key npz + json manifest, in the reference's format.

Port of ``repro/train/checkpoint.py``: ``save`` writes ``ckpt_{step}.npz``
and ``manifest.json`` (``{"step", "keys" sorted, "meta"}``), ``latest_step``
reads the manifest, ``restore`` rebuilds a state in the structure of
``like``.  The files are the reference's, key for key, so either package
restores the other's checkpoint:

* the port keeps the blocks after block 0 as a list of per-block dicts
  under ``"blocks"`` (``interop.params_from_numpy``); the reference stacks
  the same leaves under ``"blocks_dense"`` with a leading (L-1) axis.
  ``save`` writes them stacked and ``restore`` unstacks them, wherever the
  list sits (``params``, ``opt/m``, ``opt/v``);
* AdamW's step count is a Python int here and a 0-d int32 array there
  (``opt/count``): written as ``np.int32``, read back as an int;
* bfloat16 leaves: numpy has no bfloat16, and an npz written by the
  reference stores them as raw 2-byte void (``|V2``) arrays.  The port
  writes its bf16 leaves the same raw way and reads a ``|V2`` leaf by
  reinterpreting its bits as bfloat16.

Each leaf reaches the host in one device-to-host copy (a stacked leaf: one
copy per block, into its slice of the host array); nothing loops over
elements in Python.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

_STACKED = "blocks_dense"


def _host(t: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    t = t.detach()
    if out is None:
        return t.to("cpu", copy=True)
    out.copy_(t)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bf16 as raw ``|V2`` words (the reference's
    npz layout of ml_dtypes' bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _stack(blocks):
    """A list of per-block trees -> the reference's stacked tree of numpy
    arrays with a leading block axis."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    out = torch.empty((len(blocks),) + tuple(first.shape), dtype=first.dtype)
    for i, t in enumerate(blocks):
        _host(t, out[i])
    return _numpy(out)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "blocks" and isinstance(v, list):
                if v:
                    out.update(_flatten(_stack(v), f"{prefix}{_STACKED}/"))
            else:
                out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = _numpy(_host(tree))
    elif isinstance(tree, np.ndarray):      # a stacked leaf, on the host
        out[prefix[:-1]] = tree
    else:                                   # AdamW's count: the 0-d int32
        out[prefix[:-1]] = np.asarray(tree, dtype=np.int32)
    return out


def save(path, state, step=0, meta=None):
    """Write ``state`` (the port's {"params", "opt"} or any tree of tensors
    and ints) as ``ckpt_{step}.npz`` in the reference's layout, and the
    manifest."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(state)
    np.savez(os.path.join(path, f"ckpt_{step}.npz"), **flat)
    manifest = {"step": step, "keys": sorted(flat), "meta": meta or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def latest_step(path):
    if not os.path.isfile(os.path.join(path, "manifest.json")):
        return None
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["step"]


def _tensor(arr, like: torch.Tensor, key) -> torch.Tensor:
    if arr.shape != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, the "
                         f"state expects {tuple(like.shape)}")
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # raw bfloat16
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device=like.device, dtype=like.dtype, copy=True)
    return t.requires_grad_(like.requires_grad)


def restore(path, like, step=None):
    """Restore into the structure of ``like`` (the port's layout): shapes
    are checked against ``like``; tensors come back in ``like``'s dtype, on
    its device, requiring gradients where its leaves do; ints (AdamW's
    count) as ints.  Reads the latest step unless ``step`` is given."""
    step = latest_step(path) if step is None else step
    with np.load(os.path.join(path, f"ckpt_{step}.npz")) as data:
        return _rebuild(data, like)


def _rebuild(data, like):
    stacked = {}            # a stacked leaf is read once for all its blocks

    def load(key, index):
        if index is None:
            return data[key]
        if key not in stacked:
            stacked[key] = data[key]
        return stacked[key][index]

    def rebuild(tree, prefix="", index=None):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k == "blocks" and isinstance(v, list) and index is None:
                    out[k] = [rebuild(b, f"{prefix}{_STACKED}/", i)
                              for i, b in enumerate(v)]
                else:
                    out[k] = rebuild(v, f"{prefix}{k}/", index)
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/", index)
                              for i, v in enumerate(tree))
        key = prefix[:-1]
        arr = load(key, index)
        if isinstance(tree, torch.Tensor):
            return _tensor(arr, tree, key)
        return int(arr)

    return rebuild(like)
