"""Tensor-parallel layout of the decoder's parameters.

Port of ``repro/launch/mesh.py:47-147`` (``_BASE``, ``_MOE``, ``param_specs``,
``kv_replicated``) for the explicit-TP stack, where each rank holds its
shard (the reference's 256- and 512-chip pod meshes have no port; data
parallelism is a process group of its own, ``core.tp.split_groups``).
Megatron's layout over the block weights:

  attention  wq / wk / wv by output columns (whole heads), wo by input rows
  FFN        wi / wg by columns, wo by rows
  MoE FFN    the experts' wi / wg / wo by experts (dim 0), the router
             replicated, the shared expert like a dense FFN (``_MOE``,
             reference ``:71-76``)
  the rest   replicated: norms, qk-norms, and outside the blocks the
             embedding, positions, final norm and head (the stack shards
             only the blocks, reference ``model.py:180-185``)

With ``kv_replicated`` (``n_kv_heads < tp``) wk / wv stay whole on every
rank and each rank slices its KV group (``attention._kv_group_slice``).
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import kv_replicated as _kv_replicated
from repro_torch.models.blocks import is_moe
from repro_torch.optim.adamw import map_tree, named_leaves

#: dim each block leaf is sharded along: 1 columns, 0 rows
_BLOCK = {("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1,
          ("attn", "wo"): 0, ("ffn", "wi"): 1, ("ffn", "wg"): 1,
          ("ffn", "wo"): 0}
_KV = (("attn", "wk"), ("attn", "wv"))
#: a MoE FFN's leaves: (E, d, f) / (E, f, d) experts split by experts, the
#: shared expert's swiglu MLP as a dense FFN; the router is replicated
_MOE = {("ffn", "wi"): 0, ("ffn", "wg"): 0, ("ffn", "wo"): 0,
        ("shared", "wi"): 1, ("shared", "wg"): 1, ("shared", "wo"): 0}


def _block_specs(block, kv_rep):
    moe = is_moe(block)

    def spec(path):
        if kv_rep and path[-2:] in _KV:
            return None
        if moe and path[0] == "ffn":
            return _MOE.get(path[-2:])
        return _BLOCK.get(path[-2:])
    return _tree_of(block, spec)


def _tree_of(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _tree_of(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_of(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path)


def param_specs(params, cfg, tp_size, kv_replicated=None):
    """The params' tree with each leaf replaced by the dim it is sharded
    along (1: columns, 0: rows) or None (replicated).  Works on any tree of
    the params' structure (gradients, AdamW moments) and on one block."""
    kv_rep = _kv_replicated(cfg, tp_size) if kv_replicated is None \
        else kv_replicated
    if "attn" in params:                                   # one block
        return _block_specs(params, kv_rep)
    specs = map_tree(lambda _: None, params)
    specs["block0"] = _block_specs(params["block0"], kv_rep)
    specs["blocks"] = [_block_specs(b, kv_rep) for b in params["blocks"]]
    return specs


def sharded_paths(params, cfg, tp_size, kv_replicated=None) -> frozenset:
    """Paths (``adamw.named_leaves``) of the leaves each rank holds a shard
    of."""
    specs = dict(named_leaves(param_specs(params, cfg, tp_size,
                                          kv_replicated)))
    return frozenset(p for p, s in specs.items() if s is not None)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _apply(tree, specs, fn):
    out = map_tree(lambda t: t, tree)
    for path, spec in named_leaves(specs):
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = fn(path, spec)
    return out


def shard_params(params, cfg, rank, tp_size, kv_replicated=None):
    """Rank ``rank``'s shard of the full ``params`` (the model's tree, one
    block, or a tree of the same structure): sharded leaves as contiguous
    copies of their slice (no view keeps the full leaf alive), replicated
    leaves the same tensors as given."""
    specs = param_specs(params, cfg, tp_size, kv_replicated)

    def cut(path, spec):
        t = _leaf(params, path)
        if spec is None:
            return t
        return t.detach().chunk(tp_size, dim=spec)[rank].clone(
            memory_format=torch.contiguous_format)
    return _apply(params, specs, cut)


def gather_params(shards, cfg, kv_replicated=None):
    """The inverse of ``shard_params``: the per-rank trees (by rank) ->
    the full tree; replicated leaves are taken from rank 0."""
    tp_size = len(shards)
    specs = param_specs(shards[0], cfg, tp_size, kv_replicated)

    def join(path, spec):
        parts = [_leaf(s, path) for s in shards]
        if spec is None:
            return parts[0]
        return torch.cat([p.detach() for p in parts], dim=spec)
    return _apply(shards[0], specs, join)


def gather_over_group(shard, cfg, group, kv_replicated=None):
    """The full tree from every rank's ``shard`` (params, or an AdamW
    moment of the same structure) over the TP ``group``, collectively:
    each sharded leaf is all-gathered into host memory and joined along
    its dim; replicated leaves are this rank's, as given.  The
    collective ``gather_params``, for checkpoints."""
    from repro_torch.core import tp
    specs = param_specs(shard, cfg, group.size(), kv_replicated)

    def join(path, spec):
        t = _leaf(shard, path)
        if spec is None:
            return t
        parts = tp.gather_rows(t, group, "checkpoint", host=True)
        return torch.cat(parts.unbind(0), dim=spec)
    return _apply(shard, specs, join)
