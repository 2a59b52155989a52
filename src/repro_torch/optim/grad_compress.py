"""Lossy gradient compression: the paper's Fig 7 baselines and the
compressed backward collectives of explicit tensor parallelism.

Port of ``repro/optim/grad_compress.py`` on torch tensors over a process
group.

* Grad-Q [QSGD]: ``quantize_int8`` quantises each leaf to int8 against
  its amax and dequantises it (the communication payload's effect).
* Grad-LR [PowerSGD]: ``lowrank`` keeps a rank-r approximation of each
  2-D leaf, ``Q (Q^T g)`` with ``Q = qr(g Omega)`` against a fixed random
  projection.
* ``compressed_bytes`` bills a tree's payload per method at each leaf's
  own itemsize.

The exchanges (``ExecutionPlan.grad_compress``; ``core/tp.py`` calls them
from the backward of ``enter`` and of ``scatter_seq``, never in a forward):

* ``_int8_allreduce``: the cotangent in ``n`` row chunks (one a rank),
  each quantised against its own amax and sent by an all-to-all (the
  reduce-scatter phase); each rank dequantises and sums its chunk,
  requantises it and an int8 all-gather brings every chunk back.  A chunk's
  scale rides in the same int8 message as its codes (its bytes appended),
  so one compressed all-reduce is one all-to-all and one all-gather.
  Wire bytes are ~2 x (n-1)/n bytes an element against 8 x (n-1)/n for an
  fp32 ring all-reduce.
* ``_lowrank_allreduce``: the cotangent as (m, d), the summed gradient as
  ``Q (Q^T sum g)``: two all-reduces of (m, r) and (r, d) in place of one
  of (m, d); the exact all-reduce where ``min(m, d) <= r``.
* ``_int8_allgather`` / ``_lowrank_allgather``: the tiled all-gather
  along dim 1 (sequence parallelism's backward of a reduce-scatter), of the
  quantised shard or of each shard's rank-r factors.

The operation order is the reference's (``round(g / a * 127)``, clip to
[-127, 127]; ``torch.round`` and ``jnp.round`` both round half to even),
and the dequantisation is the reference's as XLA compiles it: ``a / 127``
becomes ``a * float32(1 / 127)``, and the sum over ranks of ``q_i s_i``
fused multiply-adds in rank order (emulated in float64, where each
product of a code and a float32 scale is exact).  So on the same inputs
the int8 codes and scales are equal.
Omega is ``jax.random.normal(PRNGKey(k), (d, r), float32)`` through
``serve/prng.py`` (threefry bits exact, ``erfinv`` to a few ulps) with the
reference's ``k``.  ``q (q^T g)`` does not depend on the signs QR gives
Q's columns, so ``torch.linalg.qr`` serves.  For a non-fp32 cotangent
Omega and the QR are taken in fp32 and cast (the reference draws Omega in
the cotangent's dtype).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import tp
from repro_torch.optim.adamw import map_tree, named_leaves
from repro_torch.serve import prng

GRAD_COMPRESS_METHODS = ("none", "int8", "lowrank")

_LOWRANK_RANK = 4


def _quantize(g, a):
    return torch.clamp(torch.round(g / a * 127), -127, 127).to(torch.int8)


def _step(a):
    """The dequantisation step of scale ``a``: ``a / 127`` as XLA compiles
    it, ``a`` times the reciprocal rounded to ``a``'s dtype."""
    return a * torch.tensor(1 / 127, dtype=a.dtype, device=a.device)


def _fma_sum(codes, steps):
    """sum_i codes[i] steps[i] over dim 0, as fused multiply-adds in order
    (the first product rounded alone), in ``steps``' dtype."""
    acc = codes[0].to(steps.dtype) * steps[0]
    for i in range(1, codes.shape[0]):
        acc = (codes[i].double() * steps[i].double()
               + acc.double()).to(steps.dtype)
    return acc


def quantize_int8(tree):
    def q(g):
        a = g.abs().max() + 1e-12
        return _quantize(g, a).to(g.dtype) * _step(a)
    return map_tree(q, tree)


@functools.lru_cache(maxsize=64)
def _omega(key, d, r, device):
    """``jax.random.normal(PRNGKey(key), (d, r), float32)`` on ``device``."""
    keys = prng.prng_key(key).to(device)
    return prng.normal(keys, d * r).reshape(d, r)


def _projection(key, g, r):
    return _omega(key, g.shape[1], r, str(g.device)).to(g.dtype)


def _qr_q(p):
    q, _ = torch.linalg.qr(p.float())
    return q.to(p.dtype)


def lowrank(tree, rank=4, seed=0):
    def lr(g):
        if g.dim() != 2 or min(g.shape) <= rank:
            return g
        omega = _projection(seed + g.shape[0] * 131 + g.shape[1], g, rank)
        q = _qr_q(g @ omega)                # (m, r)
        return q @ (q.T @ g)
    return map_tree(lr, tree)


def compressed_bytes(tree, method, rank=4):
    """Communication payload of ``tree`` under ``method``, each leaf billed
    at its own itemsize: ``int8`` one byte an element plus one fp32 scale;
    ``lowrank`` the factored (m + n) r payload of the 2-D leaves
    ``lowrank()`` compresses, the others whole."""
    total = 0
    for _, g in named_leaves(tree):
        itemsize = g.element_size()
        if method == "none":
            total += g.numel() * itemsize
        elif method == "int8":
            total += g.numel() + 4
        elif method == "lowrank":
            if g.dim() == 2 and min(g.shape) > rank:
                total += (g.shape[0] + g.shape[1]) * rank * itemsize
            else:
                total += g.numel() * itemsize
    return total


# --------------------------------------------------------------------------- #
# compressed backward collectives (ExecutionPlan.grad_compress)
# --------------------------------------------------------------------------- #
def _pack(codes, scales):
    """int8 codes (k, c) and one scale a row (k, 1) -> (k, c + itemsize)
    int8: each row's scale bytes appended to its codes."""
    raw = scales.contiguous().view(torch.int8).reshape(codes.shape[0], -1)
    return torch.cat([codes, raw], dim=1)


def _unpack(packed, c, dtype):
    codes = packed[:, :c]
    scales = packed[:, c:].contiguous().view(dtype)       # (k, 1)
    return codes, scales


def _int8_allreduce(ct, group, direction="backward"):
    """Two-phase QSGD all-reduce of ``ct`` over ``group``: per-chunk int8
    quantise -> all-to-all -> local dequantise and sum -> requantise the
    reduced chunk -> int8 all-gather.  Replicated output, like a sum."""
    n_ranks = group.size()
    flat = ct.reshape(-1)
    n = flat.numel()
    pad = (-n) % n_ranks
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(n_ranks, -1)          # chunk j -> rank j
    c = chunks.shape[1]
    a = chunks.abs().amax(dim=1, keepdim=True) + 1e-12
    got = tp.exchange_rows(_pack(_quantize(chunks, a), a), group, direction)
    q8x, ax = _unpack(got, c, ct.dtype)
    shard = _fma_sum(q8x, _step(ax))                            # (c,)
    a2 = shard.abs().max().reshape(1, 1) + 1e-12
    q2 = _quantize(shard[None], a2)
    g8, ga = _unpack(tp.gather_rows(_pack(q2, a2)[0], group, direction),
                     c, ct.dtype)                               # (n, c)
    out = (g8.to(ct.dtype) * _step(ga)).reshape(-1)
    return out[:n].reshape(ct.shape)


def _lowrank_allreduce(ct, group, direction="backward"):
    """PowerSGD all-reduce: the SUMMED cotangent as Q (Q^T sum g) through
    two rank-r all-reduces; the exact all-reduce when ``ct`` has no
    compressible 2-D shape."""
    r = _LOWRANK_RANK
    d = ct.shape[-1]
    m = ct.numel() // d
    if ct.dim() < 2 or min(m, d) <= r:
        return tp.all_reduce(ct, group, direction)
    g = ct.reshape(m, d)
    omega = _projection(m * 131 + d, g, r)
    p = tp.all_reduce(g @ omega, group, direction)          # (m, r)
    q = _qr_q(p)
    qtg = tp.all_reduce(q.T @ g, group, direction)          # (r, d)
    return (q @ qtg).reshape(ct.shape)


def _tile(stacked):
    """(n, B, s, ...) per-rank shards -> (B, n s, ...), rank j's shard at
    rows [j s, (j+1) s) of dim 1 (the tiled gather's layout)."""
    out = stacked.movedim(0, 1)
    return out.reshape((out.shape[0], -1) + tuple(out.shape[3:]))


def _int8_allgather(ct, group, direction="backward"):
    """int8 all-gather along dim 1 (tiled): quantise the local shard, send
    int8 codes and one scale, dequantise each rank's stripe by its scale."""
    a = ct.abs().max().reshape(1, 1) + 1e-12
    q8 = _quantize(ct, a).reshape(1, -1)
    g8, ga = _unpack(tp.gather_rows(_pack(q8, a)[0], group, direction),
                     q8.shape[1], ct.dtype)                     # (n, numel)
    scale = _step(ga).reshape((-1,) + (1,) * ct.dim())
    return _tile(g8.reshape((-1,) + tuple(ct.shape)).to(ct.dtype) * scale)


def _lowrank_allgather(ct, group, direction="backward"):
    """Rank-r all-gather along dim 1: each rank sends its shard's (m, r)
    and (r, d) PowerSGD factors, every rank rebuilds every shard; the exact
    gather when the shard is not compressible."""
    r = _LOWRANK_RANK
    d = ct.shape[-1]
    m = ct.numel() // d
    if ct.dim() < 2 or min(m, d) <= r:
        return tp.seq_collective(ct, group, direction, gather=True)
    g = ct.reshape(m, d)
    omega = _projection(m * 131 + d, g, r)
    q = _qr_q(g @ omega)
    qtg = q.T @ g
    gq = tp.gather_rows(q, group, direction)                 # (n, m, r)
    gt = tp.gather_rows(qtg, group, direction)               # (n, r, d)
    full = torch.einsum("tmr,trd->tmd", gq, gt)              # (n, m, d)
    return _tile(full.reshape((-1,) + tuple(ct.shape)))


#: the compressed exchanges by ``ExecutionPlan.grad_compress`` method
ALL_REDUCE = {"int8": _int8_allreduce, "lowrank": _lowrank_allreduce}
ALL_GATHER = {"int8": _int8_allgather, "lowrank": _lowrank_allgather}
