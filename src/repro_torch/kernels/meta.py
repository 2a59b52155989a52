"""The kernels' third route, for ``meta`` tensors: shapes, dtypes and the
allocations of the CUDA route, and no arithmetic.

The dry run (``launch/dryrun.py``) runs a whole train step, prefill or
decode tick on ``meta`` tensors.  There a kernel wrapper returns empty
outputs of the kernel's shapes and dtypes and allocates what its CUDA route
allocates (flash's ``lse``, the paged kernels' split workspaces, the LN
backward's partial rows), so that a storage tracker sees the card's live
set.  It adds the kernel's work to ``COUNTS``, by kernel label, with the
formulas of the kernels' ``bound_ms``: ``flops`` the matmul operations (4 D
a visible (query, key) pair a head for attention; the backward 2.5x the
forward's; ``fused_ln_add`` and ``page_copy`` none) and ``bytes`` each
input read once and each output written once.  Plain blockwise arithmetic
is never counted for a kernel: on ``meta`` it never runs.
"""
from __future__ import annotations

#: {kernel label: {"calls", "flops", "bytes"}} since the last ``reset()``
COUNTS = {}
#: streaming multiprocessors of the card the meta route stands for (the
#: H100 SXM): the LN backward's partial rows are sized by it on the card
SMS = 132


def reset():
    COUNTS.clear()


def counts() -> dict:
    return {k: dict(v) for k, v in COUNTS.items()}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def add(label, flops, read, written):
    """Count one meta launch of ``label``: ``flops`` operations, ``read``
    and ``written`` the kernel's inputs and outputs (tensors or None)."""
    c = COUNTS.setdefault(label, {"calls": 0, "flops": 0, "bytes": 0})
    c["calls"] += 1
    c["flops"] += int(flops)
    c["bytes"] += nbytes(*read) + nbytes(*written)


def route(t, plain, meta_fn, cuda):
    """The function for ``t``'s device: the plain version for CPU tensors,
    the meta route for ``meta`` tensors, the CUDA route otherwise (it takes
    CUDA tensors or raises)."""
    return {"cpu": plain, "meta": meta_fn}.get(t.device.type, cuda)
