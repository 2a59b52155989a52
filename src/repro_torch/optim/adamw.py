"""AdamW with global-norm clipping, on the port's parameter tree.

Port of ``repro/optim/adamw.py:14-72`` with the reference's formula: clip
the gradients by their global norm; count from 1; ``m`` and ``v`` in
``state_dtype``; on decayed leaves
``step = (m / bc1) / (sqrt(v / bc2) + eps) + weight_decay * p``, and
``p -= lr * step``.

Two differences of form, none of result:

* The reference is pure and returns new trees; here ``adamw_update`` updates
  the params and the state IN PLACE under ``torch.no_grad()``, one leaf at a
  time, so the temporaries never exceed a few copies of the largest leaf
  (at llama3.2-3b the tied embedding, 1.6 GB in fp32).  A ``torch._foreach``
  over all leaves at once would hold full-size temporaries for every leaf.
* The decay mask.  The reference decays leaves with ``p.ndim >= 2``
  (``_decay_mask``), judged on ITS layout, where the blocks after block 0
  are stacked along a leading layer axis: their norm scales are
  (L - 1, d) and are decayed, while block 0's norms and ``final_norm`` are
  not.  The port keeps every stack as a list of per-layer dicts (zamba's
  groups a list of lists), so a leaf is judged by its stacked rank: its
  ``ndim`` plus one for each list it sits in.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable | float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.001
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # bf16 for the 671B config (DESIGN.md §4)


def named_leaves(tree, path=()):
    """(path, tensor) for every leaf, dict keys in sorted order (the
    reference's ``jax.tree.leaves`` order), list items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from named_leaves(t, path + (i,))
    else:
        yield path, tree


def map_tree(fn, tree):
    """The tree with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def decay_mask(path, p) -> bool:
    """The reference's ``p.ndim >= 2`` on the reference's layout: each list
    index on the leaf's path (a stacked axis there) counts one more
    dimension."""
    stacked = sum(isinstance(k, int) for k in path)
    return p.dim() + stacked >= 2


def init_opt_state(params, ocfg: AdamWConfig):
    dt = getattr(torch, ocfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "count": 0}


def global_norm(tree, group=None, sharded=frozenset()):
    """sqrt of the sum of squares of every leaf, in fp32, as a 0-d tensor
    (no sync with the host).  ``square().sum()``, the reference's formula:
    ``torch.linalg.vector_norm`` on the CPU loses about 1% on a leaf of
    1e8 values (an fp32 accumulation).

    Under explicit TP (``group``) the leaves at ``sharded`` paths
    (``launch.mesh.sharded_paths``) are this rank's shards: their squares
    are summed over the group in one all-reduce of a scalar, and the
    replicated leaves, equal on every rank, count once."""
    sq = {path: x.float().square().sum() for path, x in named_leaves(tree)}
    if group is None:
        return torch.sqrt(torch.stack(list(sq.values())).sum())
    from repro_torch.core import tp
    zero = next(iter(sq.values())).new_zeros(())
    shards = sum((v for p, v in sq.items() if p in sharded), zero)
    rest = sum((v for p, v in sq.items() if p not in sharded), zero)
    shards = shards.reshape(1)
    tp.all_reduce_([shards], group)
    return torch.sqrt(rest + shards[0])


@torch.no_grad()
def adamw_update(params, grads, opt_state, ocfg: AdamWConfig, *, group=None,
                 sharded=frozenset()):
    """One AdamW step, in place: ``params``, ``opt_state`` and ``grads``
    (clipped) are updated; returns (params, opt_state, grad_norm) with the
    pre-clip global norm as a 0-d fp32 tensor.  The learning rate
    ``ocfg.lr(count)`` and the bias corrections are computed on the host in
    fp32, as the reference computes them in ``jnp.float32``.  Under
    explicit TP (``group``, ``sharded``: see ``global_norm``) each rank
    updates its shards and the replicated leaves; the clip is the global
    norm of the whole model's gradient."""
    count = opt_state["count"] + 1
    lr = ocfg.lr(count) if callable(ocfg.lr) else ocfg.lr
    lr = float(np.float32(lr))
    gnorm = global_norm(grads, group, sharded)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    bc1 = float(np.float32(1) - np.float32(ocfg.b1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(ocfg.b2) ** np.float32(count))
    m_leaves = dict(named_leaves(opt_state["m"]))
    v_leaves = dict(named_leaves(opt_state["v"]))
    for path, g in named_leaves(grads):
        p = _leaf(params, path)
        m, v = m_leaves[path], v_leaves[path]
        g32 = g.float().mul_(scale)     # fp32 grads: clipped in place
        m32, v32 = m.float(), v.float()
        m32.mul_(ocfg.b1).add_(g32, alpha=1 - ocfg.b1)
        v32.mul_(ocfg.b2).addcmul_(g32, g32, value=1 - ocfg.b2)
        step = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(ocfg.eps))
        p32 = p.float()
        if decay_mask(path, p):
            step.add_(p32, alpha=ocfg.weight_decay)
        p32.sub_(step.mul_(lr))
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if dst is not src:
                dst.copy_(src)
    opt_state["count"] = count
    return params, opt_state, gnorm


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree
