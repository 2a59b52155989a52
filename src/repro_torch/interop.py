"""Carry the JAX package's parameters across to the port.

``params_from_numpy(tree, cfg, device)`` takes the reference's parameter
tree with every leaf converted to a numpy array (``jax.tree.map(np.asarray,
params)``) and returns the port's tree: the stacked ``blocks_dense`` leaves
(leading layer axis) become a list of per-layer dicts under ``"blocks"``,
matmul weights and embeddings are cast to ``cfg.dtype`` and norm scales and
biases stay fp32.  bfloat16 leaves come through fp32, because
``torch.from_numpy`` does not take ml_dtypes' bfloat16.
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


def params_from_numpy(tree, cfg, device="cpu"):
    """The reference's dense-decoder params (numpy leaves) -> the port's."""
    if "blocks_moe" in tree:
        raise NotImplementedError(
            "MoE parameters come with the family-breadth slice of the "
            "PyTorch port")
    dtype = getattr(torch, cfg.dtype)
    device = torch.device(device)
    out = {k: _convert(v, dtype, device) for k, v in tree.items()
           if k != "blocks_dense"}
    stacked = tree.get("blocks_dense")
    n = 0 if stacked is None else len(np.asarray(stacked["ln1"]["scale"]))
    out["blocks"] = [_convert(_unstack(stacked, i), dtype, device)
                     for i in range(n)]
    return out


def tree_to(tree, device):
    """Copy every tensor of a params or cache tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)
