"""Checkpoints: flat-key npz + json manifest, in the reference's format.

Port of ``repro/train/checkpoint.py``: ``save`` writes ``ckpt_{step}.npz``
and ``manifest.json`` (``{"step", "keys" sorted, "meta"}``), ``latest_step``
reads the manifest, ``restore`` rebuilds a state in the structure of
``like``.  The files are the reference's, key for key, so either package
restores the other's checkpoint:

* the port keeps the decoder's blocks after block 0 as a list of
  per-block dicts under ``"blocks"`` (``interop.params_from_numpy``); the
  reference stacks the same leaves with a leading layer axis, the dense
  blocks under ``"blocks_dense"`` and the MoE blocks (their FFN has a
  ``router``) under ``"blocks_moe"``.  ``save`` writes each kind stacked
  and ``restore`` unstacks them, wherever the list sits (``params``,
  ``opt/m``, ``opt/v``);
* every other list is a stack the reference keeps under the list's own
  key: mamba's ``blocks`` (its blocks have a ``mixer``, no ``ffn``),
  zamba's ``mamba`` (a list of groups, each a list of layers: stacked
  (n_groups, attn_every, ...)) and ``mamba_tail``, whisper's
  ``enc_blocks`` and ``dec_blocks``;
* every other subtree is written and read under its own keys, as the
  reference flattens it: MLA's attention leaves (``.../attn/w_dq`` ...)
  and DeepSeek-V3's ``mtp`` head (``params/mtp/proj/w``,
  ``params/mtp/block/...``), which stays whole under TP;
* AdamW's step count is a Python int here and a 0-d int32 array there
  (``opt/count``): written as ``np.int32``, read back as an int;
* bfloat16 leaves: numpy has no bfloat16, and an npz written by the
  reference stores them as raw 2-byte void (``|V2``) arrays.  The port
  writes its bf16 leaves the same raw way and reads a ``|V2`` leaf by
  reinterpreting its bits as bfloat16.

Each leaf reaches the host in one device-to-host copy (a stacked leaf: one
copy per block, into its slice of the host array); nothing loops over
elements in Python.

Under tensor and data parallelism (``save_distributed``,
``restore_sharded``) the file is the one-device format: the data rank 0's
TP group gathers the params and both AdamW moments into host memory
(``launch.mesh.gather_over_group``), its rank 0 writes them, and every
rank waits at a barrier; restoring reads the whole file on each rank's
host and cuts that rank's shard (``launch.mesh.shard_params``' layout).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as MX
from repro_torch.models.blocks import is_moe
from repro_torch.optim.adamw import named_leaves

#: the reference's stack of each block kind: dense, MoE
_STACKS = ("blocks_dense", "blocks_moe")


def _stack_of(block) -> str:
    """The reference's stack of a decoder block (or a tree of its
    structure)."""
    return _STACKS[int(is_moe(block))]


def _by_kind(key, blocks) -> bool:
    """Whether a list is the decoder's blocks, stacked by FFN kind."""
    return key == "blocks" and isinstance(blocks[0], dict) \
        and "ffn" in blocks[0]


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
    """A list of per-block trees (or of such lists) -> the reference's
    stacked tree of numpy arrays with a leading block axis (two for a list
    of lists)."""
    first = blocks[0]
    if isinstance(first, list):
        flat = _stack([b for group in blocks for b in group])
        return _reshape(flat, (len(blocks), len(first)))
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    out = torch.empty((len(blocks),) + tuple(first.shape), dtype=first.dtype)
    for i, t in enumerate(blocks):
        _host(t, out[i])
    return _numpy(out)


def _reshape(tree, lead):
    if isinstance(tree, dict):
        return {k: _reshape(v, lead) for k, v in tree.items()}
    return tree.reshape(lead + tree.shape[1:])


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, list) and _by_kind(k, v):
                for name in _STACKS:
                    part = [b for b in v if _stack_of(b) == name]
                    if part:
                        out.update(_flatten(_stack(part), f"{prefix}{name}/"))
            elif isinstance(v, list):
                out.update(_flatten(_stack(v), f"{prefix}{k}/"))
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


def _state_specs(state, cfg, tp_size):
    """{path in ``state``: sharded dim} of the params and both moments."""
    trees = {("params",): state["params"], ("opt", "m"): state["opt"]["m"],
             ("opt", "v"): state["opt"]["v"]}
    return {prefix + p: s for prefix, tree in trees.items()
            for p, s in named_leaves(MX.param_specs(tree, cfg, tp_size))
            if s is not None}


def save_distributed(path, state, cfg, plan, step=0, meta=None):
    """``save`` of a state held under ``plan``'s TP and data groups, in
    the one-device format: data rank 0's TP ranks gather the params and
    moments (one all-gather a sharded leaf, direction ``checkpoint``), the
    rank that is TP and data rank 0 writes, and every rank waits at a
    barrier of the whole world.  Returns the gathered state (sharded
    leaves in host memory) on data rank 0's ranks, None on the others."""
    if plan.dp_rank == 0:
        if plan.group is not None:
            opt = state["opt"]
            state = {"params": MX.gather_over_group(state["params"], cfg,
                                                    plan.group),
                     "opt": {"m": MX.gather_over_group(opt["m"], cfg,
                                                       plan.group),
                             "v": MX.gather_over_group(opt["v"], cfg,
                                                       plan.group),
                             "count": opt["count"]}}
        if plan.tp_rank == 0:
            save(path, state, step=step, meta=meta)
    dist.barrier()
    return state if plan.dp_rank == 0 else None


def restore_sharded(path, like, cfg, plan, step=None):
    """``restore`` into ``like``, this TP rank's state under ``plan``: the
    whole file is read on the host and each sharded leaf cut to this
    rank's part before it reaches ``like``'s device."""
    specs = _state_specs(like, cfg, plan.tp_size)
    n, r = plan.tp_size, plan.tp_rank

    def cut(p, arr):
        s = specs.get(p)
        if s is None:
            return arr
        k = arr.shape[s] // n
        index = [slice(None)] * arr.ndim
        index[s] = slice(r * k, (r + 1) * k)
        return arr[tuple(index)]

    step = latest_step(path) if step is None else step
    with np.load(os.path.join(path, f"ckpt_{step}.npz")) as data:
        return _rebuild(data, like, cut)


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


def _rebuild(data, like, cut=None):
    """``like``'s structure from the npz ``data``; ``cut(path, array)``,
    where given, trims each leaf (``path``: its keys in ``like``)."""
    stacked = {}            # a stacked leaf is read once for all its blocks

    def load(key, index):
        if index is None:
            return data[key]
        if key not in stacked:
            stacked[key] = data[key]
        return stacked[key][index]

    def stack(blocks, prefix, path, lead=()):
        """A stacked list: block i reads index ``lead + (i,)`` of the
        arrays under ``prefix``."""
        return [stack(b, prefix, path + (i,), lead + (i,))
                if isinstance(b, list) else
                rebuild(b, prefix, lead + (i,), path + (i,))
                for i, b in enumerate(blocks)]

    def rebuild(tree, prefix="", index=None, path=()):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if isinstance(v, list) and index is None and _by_kind(k, v):
                    # each block's index within its kind's stack
                    seen = dict.fromkeys(_STACKS, 0)
                    out[k] = []
                    for i, b in enumerate(v):
                        name = _stack_of(b)
                        out[k].append(rebuild(b, f"{prefix}{name}/",
                                              seen[name], path + (k, i)))
                        seen[name] += 1
                elif isinstance(v, list) and index is None:
                    out[k] = stack(v, f"{prefix}{k}/", path + (k,))
                else:
                    out[k] = rebuild(v, f"{prefix}{k}/", index, path + (k,))
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/", index, path + (i,))
                              for i, v in enumerate(tree))
        key = prefix[:-1]
        arr = load(key, index)
        if isinstance(tree, torch.Tensor):
            return _tensor(arr if cut is None else cut(path, arr), tree, key)
        return int(arr)

    return rebuild(like)
