"""Carry the JAX package's parameters across to the port.

``params_from_numpy(tree, cfg, device=None, dtype=None)`` takes the
reference's parameter tree with every leaf converted to a numpy array
(``jax.tree.map(np.asarray, params)``) and returns the port's tree: the
stacked ``blocks_dense`` and then ``blocks_moe`` leaves (leading layer
axis) become one list of per-layer dicts under ``"blocks"``, in depth order
(a MoE block's expert leaves stay 3-D; MLA's attention leaves and the
``mtp`` subtree, a dict like any other, cross as they are), matmul weights
and embeddings are cast to ``dtype`` (None: ``cfg.dtype``, the serving
storage; training passes ``cfg.param_dtype`` to keep the reference's fp32
masters) and norm scales and biases stay fp32.  bfloat16 leaves come
through fp32, because ``torch.from_numpy`` does not take ml_dtypes'
bfloat16.  Like every entry point of the port, ``device=None`` means the
card (``cuda``, which must exist); pass ``device="cpu"`` for the CPU.

``cache_from_numpy(tree, device=None)`` takes the reference's paged cache
with numpy leaves and returns the port's, leaf for leaf in the same dtype:
the two caches share one layout (block 0's pools, the stacked pools of the
other layers, ``a1_sig``; under MLA the pools are the latent ``c`` and rope
key ``kr``).  int8 pools cross as they are; fp8 pools cross
as the bytes of ml_dtypes' float8_e4m3fn, viewed as uint8.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_norm(d) -> bool:
    return isinstance(d, dict) and "scale" in d


def _tensor(a, dtype, device):
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":         # ml_dtypes bfloat16 / float8
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                       dtype=dtype)


def _convert(tree, dtype, device):
    if _is_norm(tree):
        return {k: _tensor(v, torch.float32, device) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device) for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


#: the reference's stacks of the blocks after block 0, in depth order
STACKS = ("blocks_dense", "blocks_moe")


def params_from_numpy(tree, cfg, device=None, dtype=None):
    """The reference's decoder params (numpy leaves) -> the port's, on
    ``device`` (None: the card, via ``models.model.resolve_device``),
    matmul weights and embeddings in ``dtype`` (None: ``cfg.dtype``)."""
    from repro_torch.models.model import check_supported, resolve_device
    check_supported(cfg)
    dtype = getattr(torch, dtype or cfg.dtype)
    device = resolve_device(device)
    out = {k: _convert(v, dtype, device) for k, v in tree.items()
           if k not in STACKS}
    out["blocks"] = []
    for name in STACKS:
        stacked = tree.get(name)
        n = 0 if stacked is None else len(np.asarray(
            stacked["ln1"]["scale"]))
        out["blocks"] += [_convert(_unstack(stacked, i), dtype, device)
                          for i in range(n)]
    return out


def _cache_leaf(a, device):
    a = np.ascontiguousarray(a)
    if a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8).copy())
        return t.view(torch.float8_e4m3fn).to(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a.copy()).to(device)


def cache_from_numpy(tree, device=None):
    """The reference's paged cache (numpy leaves) -> the port's, on
    ``device`` (None: the card), every leaf in its own dtype."""
    from repro_torch.models.model import resolve_device
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _cache_leaf(t, device)

    return conv(tree)


def tree_to(tree, device):
    """Copy every tensor of a params or cache tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)
