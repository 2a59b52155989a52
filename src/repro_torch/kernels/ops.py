"""Public kernel dispatchers of the PyTorch port, with dispatch telemetry.

Port of ``repro/kernels/ops.py`` for the kernels the port carries.  Each
dispatcher records, per call site and per EXECUTED call, which path ran:
``cuda-kernel`` for CUDA tensors (the hand-written kernel) and
``cpu-plain`` for CPU tensors (the kernel's plain PyTorch version).  The
path follows the tensors' device; there is no fallback from one to the
other.  ``dispatch_paths()`` holds the last path per site and the default
metrics registry counts ``kernel_dispatch_total.<site>.<path>`` in calls.
"""
from __future__ import annotations

from repro_torch.kernels import dual_branch as _db
from repro_torch.kernels import paged_attention as _pa
from repro_torch.models import layers as _layers
from repro_torch.obs import metrics as _metrics

CUDA = "cuda-kernel"
PLAIN = "cpu-plain"

#: last path run per dispatcher call site
_DISPATCH_PATHS = {}


def _record_dispatch(site: str, cuda: bool) -> str:
    path = CUDA if cuda else PLAIN
    _DISPATCH_PATHS[site] = path
    _metrics.default_registry().counter(
        f"kernel_dispatch_total.{site}.{path}", unit="calls",
        site="kernels/ops.py").inc()
    return path


def dispatch_paths() -> dict:
    """{call site: 'cuda-kernel' | 'cpu-plain'} for every dispatcher run
    since the last ``reset_dispatch_paths()``."""
    return dict(_DISPATCH_PATHS)


def reset_dispatch_paths():
    _DISPATCH_PATHS.clear()


def launch_counts() -> dict:
    """{kernel: launches since the last ``reset_launches()``} for every
    hand-written kernel of the port."""
    return {"paged_packed_attention": _pa.LAUNCHES_PACKED,
            "paged_decode_attention": _pa.LAUNCHES_DECODE,
            "paged_chunk_attention": _pa.LAUNCHES_CHUNK,
            "fused_dual_branch_decode": _db.LAUNCHES_FUSED}


def reset_launches():
    """Set every kernel's launch counter to 0."""
    _pa.reset_launches()
    _db.reset_launches()


def paged_packed_attention(q, k_pages, v_pages, block_tables, tok_slot,
                           tok_pos, *, k_scale=None, v_scale=None):
    """Packed ragged paged attention (the token-packed serving kernel):
    q (T, H, D), one flat token buffer where token t belongs to lane
    ``tok_slot[t]`` at logical position ``tok_pos[t]``, against
    (P, page, Hkv, D) pools addressed through per-slot (S, Tb) block
    tables.  Padding tokens carry tok_pos == -1 and emit exactly 0."""
    _record_dispatch("paged_packed_attention", q.device.type == "cuda")
    return _pa.paged_packed_attention(q, k_pages, v_pages, block_tables,
                                      tok_slot, tok_pos, k_scale=k_scale,
                                      v_scale=v_scale)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           k_scale=None, v_scale=None):
    """Paged-KV decode attention: q (B, H, D), one query per lane, against
    (P, page, Hkv, D) pools addressed through (B, Tb) block tables; lane b
    sees gathered keys ``j < seq_lens[b]``."""
    _record_dispatch("paged_decode_attention", q.device.type == "cuda")
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
    _record_dispatch("paged_chunk_attention", q.device.type == "cuda")
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
    _record_dispatch("dual_branch_decode", q.device.type == "cuda")
    if ffn["wi"].shape[-1] % n_tiles == 0:
        attn, y = _db.fused_dual_branch_decode(
            q.contiguous(), k_pages, v_pages, block_tables, seq_lens,
            mlp_in[:, 0].contiguous(), ffn, kind=kind)
        return attn, y[:, None]
    attn = _pa.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                      seq_lens)
    return attn, _layers.mlp_apply(ffn, mlp_in, kind)
