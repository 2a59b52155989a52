"""Public kernel dispatchers of the PyTorch port, with dispatch telemetry.

Port of ``repro/kernels/ops.py`` for the kernels this slice carries.  Each
dispatcher records, per call site and per EXECUTED call, which path ran:
``cuda-kernel`` for CUDA tensors (the hand-written kernel) and
``cpu-plain`` for CPU tensors (the kernel's plain PyTorch version).  The
path follows the tensors' device; there is no fallback from one to the
other.  ``dispatch_paths()`` holds the last path per site and the default
metrics registry counts ``kernel_dispatch_total.<site>.<path>`` in calls.
"""
from __future__ import annotations

from repro_torch.kernels import paged_attention as _pa
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
