"""Public kernel dispatchers of the PyTorch port, with dispatch telemetry.

Port of ``repro/kernels/ops.py`` for the kernels the port carries.  Each
dispatcher records, per call site and per EXECUTED call, which path ran:
``cuda-kernel`` for CUDA tensors (the hand-written kernel), ``cpu-plain``
for CPU tensors (the kernel's plain PyTorch version) and ``meta-shape`` for
``meta`` tensors (the dry run's route: outputs and workspaces of the CUDA
route's shapes, the kernel's flops and bytes counted in ``meta_counts()``,
nothing computed; ``kernels/meta.py``).  The path follows the tensors'
device; there is no fallback from one to another.  ``dispatch_paths()``
holds the last path per site and the default metrics registry counts
``kernel_dispatch_total.<site>.<path>`` in calls.  A paged call with
scale pools records its site as ``<site>.int8`` / ``<site>.fp8`` (the
reference's ``ops._kv_variant``), and a call made inside
``dispatch_site_suffix("draft")`` (the speculative draft) as
``<site>.draft`` after that, e.g. ``paged_packed_attention.int8.draft``.
Launch counters stay per kernel label, whatever the site.
"""
from __future__ import annotations

import contextlib

from repro_torch.kernels import dual_branch as _db
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_ln_add as _ln
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import paged_attention as _pa
from repro_torch.models import layers as _layers
from repro_torch.obs import metrics as _metrics

CUDA = "cuda-kernel"
PLAIN = "cpu-plain"
META = "meta-shape"

#: last path run per dispatcher call site
_DISPATCH_PATHS = {}

#: dotted suffix of the sites recorded inside ``dispatch_site_suffix``
_SITE_SUFFIX = ""


def _record_dispatch(site: str, t) -> str:
    """Record the path the call on tensor ``t`` takes, by its device."""
    if _SITE_SUFFIX:
        site = f"{site}.{_SITE_SUFFIX}"
    path = {"cuda": CUDA, "meta": META}.get(t.device.type, PLAIN)
    _DISPATCH_PATHS[site] = path
    _metrics.default_registry().counter(
        f"kernel_dispatch_total.{site}.{path}", unit="calls",
        site="kernels/ops.py").inc()
    return path


def dispatch_paths() -> dict:
    """{call site: 'cuda-kernel' | 'cpu-plain' | 'meta-shape'} for every
    dispatcher run since the last ``reset_dispatch_paths()``."""
    return dict(_DISPATCH_PATHS)


def reset_dispatch_paths():
    _DISPATCH_PATHS.clear()


@contextlib.contextmanager
def dispatch_site_suffix(suffix: str):
    """Record the dispatches run inside the context as ``<site>.<suffix>``
    (``repro/kernels/ops.py:54``): the speculative draft's calls then show
    in ``dispatch_paths()`` apart from the verify's."""
    global _SITE_SUFFIX
    prev, _SITE_SUFFIX = _SITE_SUFFIX, suffix
    try:
        yield
    finally:
        _SITE_SUFFIX = prev


def launch_counts() -> dict:
    """{kernel: launches since the last ``reset_launches()``} for every
    hand-written kernel of the port, each scale variant under its own
    ``<kernel>.int8`` / ``<kernel>.fp8`` label, and the training kernels'
    backwards under ``<kernel>.bwd``."""
    return {**_pa.LAUNCHES, "fused_dual_branch_decode": _db.LAUNCHES_FUSED,
            **_fa.LAUNCHES, **_ln.LAUNCHES}


def reset_launches():
    """Set every kernel's launch counter to 0."""
    _pa.reset_launches()
    _db.reset_launches()
    _fa.reset_launches()
    _ln.reset_launches()


def meta_counts() -> dict:
    """{kernel label: {"calls", "flops", "bytes"}} of the meta route since
    the last ``reset_meta_counts()`` (``kernels/meta.py``)."""
    return _meta.counts()


def reset_meta_counts():
    _meta.reset()


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0, scale=None,
                    q_offset=0, block_q=512):
    """Differentiable causal GQA attention for the full-sequence phases: q
    (B, Sq, H, D), k (B, Sk, Hkv, D) and v (B, Sk, Hkv, Dv), Dv <= D (MLA:
    v narrower than q / k; the kernels see v padded to D) -> (B, Sq, H,
    Dv); causal at the start (key j visible to query row i when j <=
    q_offset + i), with gemma2's sliding ``window`` (> 0: also j >
    q_offset + i - window) and logit softcap ``cap`` (!= 0).  CUDA tensors
    run the forward and backward kernels, window and cap included; CPU
    tensors the plain versions (``attention.blockwise_attention`` and its
    backward formulas), ``meta`` tensors the meta route."""
    _record_dispatch("flash_attention", q)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               cap=cap, scale=scale, q_offset=q_offset,
                               block_q=block_q)


def fused_ln_add(x, a1n, scale, bias=None, *, kind="rmsnorm", eps=1e-6):
    """Differentiable ``LN(x) * scale (+ bias) + a1n`` (FAL's MLP input),
    x and a1n (..., d) -> (..., d) in x's dtype, rounded once: the forward
    and backward kernels for CUDA tensors, ``ref.ln_add_ref``'s plain
    version (autograd through it) for CPU tensors."""
    _record_dispatch("fused_ln_add", x)
    return _ln.fused_ln_add(x, a1n, scale, bias, kind=kind, eps=eps)


def paged_packed_attention(q, k_pages, v_pages, block_tables, tok_slot,
                           tok_pos, *, k_scale=None, v_scale=None):
    """Packed ragged paged attention (the token-packed serving kernel):
    q (T, H, D), one flat token buffer where token t belongs to lane
    ``tok_slot[t]`` at logical position ``tok_pos[t]``, against
    (P, page, Hkv, D) pools addressed through per-slot (S, Tb) block
    tables.  Padding tokens carry tok_pos == -1 and emit exactly 0.
    int8 / fp8 pools come with (P, page) fp32 ``k_scale`` / ``v_scale``
    row scales (the scale variant of the kernel; likewise below)."""
    _record_dispatch(_pa.kernel_label("paged_packed_attention", k_pages,
                                      k_scale), q)
    return _pa.paged_packed_attention(q, k_pages, v_pages, block_tables,
                                      tok_slot, tok_pos, k_scale=k_scale,
                                      v_scale=v_scale)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           k_scale=None, v_scale=None):
    """Paged-KV decode attention: q (B, H, D), one query per lane, against
    (P, page, Hkv, D) pools addressed through (B, Tb) block tables; lane b
    sees gathered keys ``j < seq_lens[b]``."""
    _record_dispatch(_pa.kernel_label("paged_decode_attention", k_pages,
                                      k_scale), q)
    return _pa.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                      seq_lens, k_scale=k_scale,
                                      v_scale=v_scale)


def paged_chunk_attention(q, k_pages, v_pages, block_tables, pos, n_valid, *,
                          k_scale=None, v_scale=None):
    """Chunked paged attention, the padded (B, C) layout: q (B, C, H, D)
    chunks at per-lane positions ``pos`` (the first ``n_valid`` rows of each
    lane valid, causal within the chunk) against (P, page, Hkv, D) pools
    addressed through (B, Tb) block tables.  Rows past ``n_valid`` are
    finite but meaningless and must not be read."""
    _record_dispatch(_pa.kernel_label("paged_chunk_attention", k_pages,
                                      k_scale), q)
    return _pa.paged_chunk_attention(q, k_pages, v_pages, block_tables, pos,
                                     n_valid, k_scale=k_scale,
                                     v_scale=v_scale)


def dual_branch_decode(q, k_pages, v_pages, block_tables, seq_lens, mlp_in,
                       ffn, *, kind="swiglu"):
    """Dual-branch decode tick: paged attention || dense FFN (the FAL
    MHA||MLP property at serving time).  q (B, H, D) one query per lane;
    mlp_in (B, 1, Dm) the block's MLP input; ffn {"wi"[, "wg"], "wo"}.
    Returns (attn (B, H, D), ffn_out (B, 1, Dm)).

    The reference's route rule (``repro/kernels/ops.py:222``): when d_ff
    divides into Hkv * Tb tiles both branches go down as the one fused
    kernel; otherwise as two ops, the ``paged_decode_attention`` kernel and
    ``layers.mlp_apply``, so the two packages launch the same things for the
    same shapes.  On CPU tensors either route runs the plain attention and
    ``mlp_apply``, op for op the sequential path's, so dual and sequential
    ticks agree bit for bit there."""
    n_tiles = k_pages.shape[2] * block_tables.shape[1]
    _record_dispatch("dual_branch_decode", q)
    if ffn["wi"].shape[-1] % n_tiles == 0:
        attn, y = _db.fused_dual_branch_decode(
            q.contiguous(), k_pages, v_pages, block_tables, seq_lens,
            mlp_in[:, 0].contiguous(), ffn, kind=kind)
        return attn, y[:, None]
    attn = _pa.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                      seq_lens)
    return attn, _layers.mlp_apply(ffn, mlp_in, kind)


def copy_pages(pool, src, dst):
    """Copy-on-write page copy: pool (P, page, ...) with the full rows at
    pages ``src`` (n,) written over pages ``dst`` (n,), in place, as bytes
    (any dtype: K/V pools, int8 / fp8 pools, their fp32 scale pools).
    ``src`` / ``dst`` are host sequences of page ids; ``dst`` must be
    distinct and disjoint from ``src`` (ValueError otherwise).  Returns the
    pool."""
    _record_dispatch("copy_pages", pool)
    return _pa.page_copy(pool, src, dst)


def copy_page_leaves(leaves, src, dst):
    """``copy_pages`` over several pools at once (the same call site):
    ``leaves`` (pool, stacked) pairs, pool (P, page, ...) or, stacked, (L,
    P, page, ...), every layer of every leaf copied, in one kernel launch
    on the card.  Returns the leaves."""
    leaves = list(leaves)
    if leaves:
        _record_dispatch("copy_pages", leaves[0][0])
    return _pa.page_copy_leaves(leaves, src, dst)
