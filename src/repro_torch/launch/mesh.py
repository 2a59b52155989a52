"""Tensor-parallel layout of the decoder's parameters, and the decode
cache's layout.

Port of ``repro/launch/mesh.py:47-147`` (``_BASE``, ``_MOE``, ``param_specs``,
``kv_replicated``) for the explicit-TP stack, where each rank holds its
shard (the reference's 256- and 512-chip pod meshes have no port; data
parallelism is a process group of its own, ``core.tp.split_groups``).
Megatron's layout over the block weights:

  attention  wq / wk / wv by output columns (whole heads), wo by input rows;
             MLA's up-projections w_uq / w_uk / w_uv by columns (whole
             heads), wo by rows, its down-projections w_dq / w_dkv / w_kr
             and their norms replicated (reference ``:58-61``)
  FFN        wi / wg by columns, wo by rows
  MoE FFN    the experts' wi / wg / wo by experts (dim 0), the router
             replicated, the shared expert like a dense FFN (``_MOE``,
             reference ``:71-76``)
  cross-attention (whisper's decoder, ``xattn``) as the self-attention:
             wq / wk / wv by columns, wo by rows
  the rest   replicated: norms, qk-norms, and outside the blocks the
             embedding, positions, final norm, head and the MTP head (the
             stack shards only the blocks, reference ``model.py:180-185``;
             the MTP head runs outside it, ``:101-104``)

The blocks are the transformer blocks of every family (``BLOCK_KEYS``):
the decoder's ``block0`` / ``blocks``, whisper's ``enc_block0`` /
``enc_blocks`` / ``dec_block0`` / ``dec_blocks`` and zamba2's weight-shared
``shared`` block.  Every mamba layer stays whole (``in_proj``,
``out_proj``, ``conv_*``, ``a_log``, ``D``, ``dt_bias``: the reference's
``_BASE`` replicates the mixers over ``model``, ``:4-12``), and so do
zamba2's top-level ``in_proj`` (n_groups, 2d, d), whisper's ``pos_emb`` /
``enc_pos`` and the norms.

With ``kv_replicated`` (``n_kv_heads < tp``) wk / wv stay whole on every
rank and each rank slices its KV group (``attention._kv_group_slice``).

FSDP (ZeRO-3 over the data group, reference ``:79-153``; ``fsdp_specs``):
on top of its TP shard, each data rank holds a slice of every FSDP leaf
along the leaf's largest dim that the REFERENCE's TP spec (``_BASE`` /
``_MOE``) leaves unsharded, if that dim is at least ``FSDP_MIN_DIM``;
``emb``, positions, norms, the SSM scalars and conv, and a generic ``w``
outside the ``head`` are never sliced, nor are wk / wv under
``kv_replicated``.  The rule reads the global shape (a TP shard gives the
same answer: its TP dims are never candidates), without the reference's
leading stack axis (the port's blocks are a list).  An uneven dim is cut as
GSPMD cuts it: every rank holds ``ceil(n / dp)`` rows and the last rank's
are zero-padded (``shard_fsdp``).  A slice keeps its leaf's rank, so
AdamW's decay mask judges it as the whole leaf.  ``fsdp_layout`` gives each
FSDP leaf's (dim, n) by path, the table the model's per-unit gathers
(``core.tp.gather_fsdp``), the train step and the checkpoints read.

The decode cache (reference ``:164-204``, ``cache_specs``): which dims of
each contiguous-cache leaf are cut over the data and model ranks, rule
for rule the reference's, with ``rank_slice`` / ``leaf_ranges`` /
``slice_cache`` giving a rank's rows, heads and positions and
``seq_axes`` the groups the decode tick's softmax combines over.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.plan import kv_replicated as _kv_replicated
from repro_torch.models.blocks import is_moe
from repro_torch.optim.adamw import map_tree, named_leaves

#: dim each block leaf is sharded along: 1 columns, 0 rows
_BLOCK = {("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1,
          ("attn", "wo"): 0, ("attn", "w_uq"): 1, ("attn", "w_uk"): 1,
          ("attn", "w_uv"): 1, ("ffn", "wi"): 1, ("ffn", "wg"): 1,
          ("ffn", "wo"): 0, ("xattn", "wq"): 1, ("xattn", "wk"): 1,
          ("xattn", "wv"): 1, ("xattn", "wo"): 0}
_KV = (("attn", "wk"), ("attn", "wv"), ("xattn", "wk"), ("xattn", "wv"))
#: the params' keys that hold transformer blocks (one, or a list of them):
#: the decoder's, whisper's encoder and decoder stacks, zamba2's shared
#: block; mamba layers (no ``attn``) under ``blocks`` stay whole
BLOCK_KEYS = ("block0", "blocks", "enc_block0", "enc_blocks", "dec_block0",
              "dec_blocks", "shared")
#: a MoE FFN's leaves: (E, d, f) / (E, f, d) experts split by experts, the
#: shared expert's swiglu MLP as a dense FFN; the router is replicated
_MOE = {("ffn", "wi"): 0, ("ffn", "wg"): 0, ("ffn", "wo"): 0,
        ("shared", "wi"): 1, ("shared", "wg"): 1, ("shared", "wo"): 0}


def _block_specs(block, kv_rep):
    if "attn" not in block:                       # a mamba layer: whole
        return _tree_of(block, lambda path: None)
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
    for key in BLOCK_KEYS:
        node = params.get(key)
        if isinstance(node, dict):
            specs[key] = _block_specs(node, kv_rep)
        elif node is not None:
            specs[key] = [_block_specs(b, kv_rep) for b in node]
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


# ------------------------------------------------------------------------- #
# FSDP over the data group (reference ``_add_fsdp`` / ``_leaf_spec``)
# ------------------------------------------------------------------------- #
#: dims below this are never FSDP-sliced (reference ``_FSDP_MIN_DIM``)
FSDP_MIN_DIM = 1024

#: the reference's TP spec of a leaf key (``_BASE``): (base rank, the dims
#: it shards over ``model``); FSDP never takes a TP dim, even where the
#: port keeps the leaf whole (emb, the head) or the model axis has one rank
_REF_TP = {"emb": (2, (0,)), "wq": (2, (1,)), "wk": (2, (1,)),
           "wv": (2, (1,)), "wo": (2, (0,)), "w_dq": (2, ()),
           "w_dkv": (2, ()), "w_kr": (2, ()), "w_uq": (2, (1,)),
           "w_uk": (2, (1,)), "w_uv": (2, (1,)), "wi": (2, (1,)),
           "wg": (2, (1,)), "in_proj": (2, ()), "out_proj": (2, ())}
#: a MoE FFN's keys (``_MOE``): experts over ``model`` on dim 0
_REF_MOE_TP = {"router": (2, ()), "wi": (3, (0,)), "wg": (3, (0,)),
               "wo": (3, (0,))}
#: keys the reference never FSDP-slices (``_leaf_spec``'s exceptions)
_NO_FSDP = frozenset({"scale", "bias", "a_log", "D", "dt_bias", "conv_b",
                      "conv_w", "pos_emb", "enc_pos", "emb"})


def _fsdp_dim(key, shape, in_moe, parent):
    """The reference's FSDP dim of one leaf, or None."""
    if key == "w":
        if parent != "head":
            return None
        base, tp_dims = 2, (1,)
    elif key in _NO_FSDP:
        return None
    else:
        table = _REF_MOE_TP if in_moe and key in _REF_MOE_TP else _REF_TP
        if key not in table:
            return None
        base, tp_dims = table[key]
    extra = len(shape) - base
    if extra < 0:
        return None
    cands = [i for i, n in enumerate(shape)
             if i - extra not in tp_dims and n >= FSDP_MIN_DIM]
    return max(cands, key=lambda i: shape[i]) if cands else None


def fsdp_specs(params, cfg, tp_size, dp_size, kv_replicated=None):
    """The params' tree (or AdamW's ``m`` / ``v``, of the same structure)
    with each leaf replaced by the dim its FSDP slice is cut along, or None
    (whole on every data rank; every leaf when ``dp_size`` is 1).  Computed
    on the global shapes or on a TP shard's, which give the same answer."""
    if dp_size == 1:
        return map_tree(lambda _: None, params)
    kv_rep = _kv_replicated(cfg, tp_size) if kv_replicated is None \
        else kv_replicated

    def walk(node, key=None, in_moe=False, parent=None):
        if isinstance(node, dict):
            here = "router" in node
            # the shared expert is a dense MLP: no expert axis
            return {k: walk(v, k, (in_moe or here) and k != "shared", key)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key, in_moe, parent) for v in node]
        if kv_rep and key in ("wk", "wv"):
            return None
        return _fsdp_dim(key, tuple(node.shape), in_moe, parent)
    return walk(params)


@functools.lru_cache(maxsize=32)
def _layout(cfg, tp_size, dp_size, min_dim):
    from repro_torch.models import model as M
    full = M.init_params(cfg, device="meta")
    specs = dict(named_leaves(fsdp_specs(full, cfg, tp_size, dp_size)))
    return {p: (specs[p], t.shape[specs[p]]) for p, t in named_leaves(full)
            if specs[p] is not None}


def fsdp_layout(cfg, tp_size, dp_size) -> dict:
    """{path (``adamw.named_leaves``): (dim, n)} of every FSDP leaf of the
    config's params: the dim its slices are cut along and the dim's global
    length (the slices hold ``ceil(n / dp_size)`` rows each).  Cached; do
    not mutate."""
    return _layout(cfg, tp_size, dp_size, FSDP_MIN_DIM)


def fsdp_cuts(cfg, tp_size, dp_size, prefix) -> dict:
    """``fsdp_layout``'s entries under ``prefix``, keyed by the rest of
    their path: one unit's (a block's, the head's) table.  Cached; do not
    mutate."""
    return _cuts(cfg, tp_size, dp_size, tuple(prefix), FSDP_MIN_DIM)


@functools.lru_cache(maxsize=4096)
def _cuts(cfg, tp_size, dp_size, prefix, min_dim):
    n = len(prefix)
    return {p[n:]: c for p, c in _layout(cfg, tp_size, dp_size,
                                         min_dim).items()
            if p[:n] == prefix}


def fsdp_rows(n, dp_size) -> int:
    """Rows of one slice of a dim of ``n`` over ``dp_size`` data ranks."""
    return -(-n // dp_size)


def fsdp_slice(t, dim, rank, dp_size):
    """Data rank ``rank``'s slice of ``t`` along ``dim``: ``ceil(n / dp)``
    rows, zero-padded past the end (the last rank's), as a contiguous
    copy."""
    n = t.shape[dim]
    k = fsdp_rows(n, dp_size)
    lo, hi = min(rank * k, n), min((rank + 1) * k, n)
    part = t.detach().narrow(dim, lo, hi - lo)
    if hi - lo == k:
        return part.clone(memory_format=torch.contiguous_format)
    shape = list(t.shape)
    shape[dim] = k
    out = part.new_zeros(shape)
    out.narrow(dim, 0, hi - lo).copy_(part)
    return out


def shard_fsdp(params, cfg, rank, dp_size, tp_size=1):
    """Data rank ``rank``'s FSDP slices of ``params`` (the whole tree or
    this rank's TP shard, ``shard_params``; or a tree of its structure):
    each FSDP leaf cut along its dim by ``fsdp_slice``, the other leaves
    the same tensors as given."""
    specs = fsdp_specs(params, cfg, tp_size, dp_size)

    def cut(path, dim):
        t = _leaf(params, path)
        return t if dim is None else fsdp_slice(t, dim, rank, dp_size)
    return _apply(params, specs, cut)


def gather_fsdp(slices, cfg, tp_size=1):
    """The inverse of ``shard_fsdp``: the per-data-rank trees (by rank) ->
    the tree they were cut from, padding dropped; the other leaves from
    rank 0."""
    dp = len(slices)
    layout = fsdp_layout(cfg, tp_size, dp)

    def join(path, _):
        parts = [_leaf(s, path) for s in slices]
        if path not in layout:
            return parts[0]
        dim, n = layout[path]
        return torch.cat([p.detach() for p in parts], dim=dim).narrow(
            dim, 0, n).contiguous()
    return _apply(slices[0], map_tree(lambda _: None, slices[0]), join)


def gather_fsdp_over_group(shard, cfg, group, tp_size=1, host=True):
    """``gather_fsdp`` over the data ``group``, collectively: each FSDP
    leaf of this rank's ``shard`` (params or an AdamW moment) is
    all-gathered (direction ``checkpoint``), joined along its dim and
    trimmed; into host memory with ``host``, else on the leaf's device.
    The other leaves are this rank's, as given."""
    from repro_torch.core import tp
    layout = fsdp_layout(cfg, tp_size, group.size())

    def join(path, _):
        t = _leaf(shard, path)
        if path not in layout:
            return t
        dim, n = layout[path]
        parts = tp.gather_rows(t, group, "checkpoint", host=host)
        return torch.cat(parts.unbind(0), dim=dim).narrow(dim, 0,
                                                          n).contiguous()
    return _apply(shard, map_tree(lambda _: None, shard), join)


# ------------------------------------------------------------------------- #
# the decode cache's layout (reference ``cache_specs``, ``:164-204``)
# ------------------------------------------------------------------------- #
#: the port's two mesh axes: ``data`` is the reference's data axes together
#: (pod x data), ``model`` its model axis
DATA, MODEL = "data", "model"


def cache_specs(cfg, tp, dp, batch) -> dict:
    """The reference's decode-cache layout at ``tp`` model ranks, ``dp``
    data ranks and a global ``batch``: {leaf key: spec}, a spec giving for
    each of the leaf's own dims (without stacking axes, which stay whole)
    the axes it is cut over, data outer and model inner: ``()`` whole,
    ``(DATA,)``, ``(MODEL,)`` or ``(DATA, MODEL)``.  Rule for rule:

      * the batch is cut over the data axes when it divides them, else the
        KV sequence takes them (long_500k's batch of 1);
      * K / V (B, S, Hkv, Dh): the heads over ``model`` when they divide
        it, else the sequence takes ``model`` too (after the data axes);
      * MLA's latent ``c`` / ``kr`` (B, S, R), which has no head dim,
        always has its sequence over ``model`` (after the data axes);
      * the mamba ``state`` (B, H, P, N) / ``conv`` (B, K-1, C) and
        whisper's ``enc_out`` (B, F, d) by batch only: whole on every rank
        where the batch does not divide the data axes.

    An axis of one rank cuts nothing; ``seq_axes`` drops it."""
    b = (DATA,) if batch % dp == 0 else ()
    s_data = () if b else (DATA,)
    heads = cfg.n_kv_heads % tp == 0
    kv = (b, s_data if heads else s_data + (MODEL,),
          (MODEL,) if heads else (), ())
    lat = (b, s_data + (MODEL,), ())
    return {"k": kv, "v": kv, "c": lat, "kr": lat,
            "state": (b, (), (), ()), "conv": (b, (), ()),
            "enc_out": (b, (), ())}


def axes_part(axes, tp_rank, dp_rank, tp, dp):
    """(index, count): which of ``count`` equal parts a dim cut over
    ``axes`` (data outer, model inner) is this rank's."""
    i, n = 0, 1
    for a in axes:
        r, s = (dp_rank, dp) if a == DATA else (tp_rank, tp)
        i, n = i * s + r, n * s
    return i, n


def part_range(length, axes, tp_rank, dp_rank, tp, dp):
    """[lo, hi) of a dim of ``length`` cut over ``axes`` on this rank.
    Raises when the axes do not divide it: the layout never pads."""
    i, n = axes_part(axes, tp_rank, dp_rank, tp, dp)
    if length % n:
        raise ValueError(f"a dim of {length} does not divide over {axes} "
                         f"({n} ranks); the decode cache is not padded")
    k = length // n
    return i * k, (i + 1) * k


def leaf_ranges(spec, shape, tp_rank, dp_rank, tp, dp):
    """[lo, hi) of each dim of a cache leaf of ``shape`` on this rank:
    ``spec`` (``cache_specs``) covers the trailing dims, the leading
    stacking dims stay whole."""
    lead = len(shape) - len(spec)
    return tuple((0, n) for n in shape[:lead]) + tuple(
        part_range(n, axes, tp_rank, dp_rank, tp, dp)
        for n, axes in zip(shape[lead:], spec))


def rank_slice(cfg, tp, dp, batch, seq, tp_rank=0, dp_rank=0) -> dict:
    """A rank's slice of the decode cache: ``rows`` its batch rows and
    ``positions`` its KV sequence positions (MLA: of the latent), each
    [lo, hi) of the global batch and ``seq``."""
    specs = cache_specs(cfg, tp, dp, batch)
    b, s = specs["c" if cfg.use_mla else "k"][:2]
    return {"rows": part_range(batch, b, tp_rank, dp_rank, tp, dp),
            "positions": part_range(seq, s, tp_rank, dp_rank, tp, dp)}


def seq_axes(cfg, tp, dp, batch) -> tuple:
    """The axes of more than one rank that cut the attention cache's
    sequence (MLA's latent, else K / V): what the decode tick's softmax
    combines over.  ``()`` for the SSM family (no attention cache)."""
    if cfg.family == "ssm":
        return ()
    s = cache_specs(cfg, tp, dp, batch)["c" if cfg.use_mla else "k"][1]
    sizes = {DATA: dp, MODEL: tp}
    return tuple(a for a in s if sizes[a] > 1)


def slice_cache(cache, cfg, tp, dp, batch, tp_rank=0, dp_rank=0):
    """A rank's slice of a whole cache (the one-device ``init_cache``
    tree): every leaf cut by ``cache_specs``, contiguous copies; leaves
    outside the table whole."""
    specs = cache_specs(cfg, tp, dp, batch)

    def cut(node, key=None):
        if isinstance(node, dict):
            return {k: cut(v, k) for k, v in node.items()}
        if key not in specs:
            return node.clone()
        for dim, (lo, hi) in enumerate(leaf_ranges(
                specs[key], node.shape, tp_rank, dp_rank, tp, dp)):
            node = node.narrow(dim, lo, hi - lo)
        return node.clone(memory_format=torch.contiguous_format)
    return cut(cache)
