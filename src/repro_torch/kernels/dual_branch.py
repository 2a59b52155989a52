"""Fused dual-branch decode: paged attention || dense FFN in one dispatch,
the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/dual_branch.py:122``
``fused_dual_branch_decode`` (body ``_dual_kernel``, ``:39``).  Under the
FAL-family connections a decode block's MLP input does not depend on that
block's attention, so the paged KV gather and the FFN weight reads can go
down together.  The kernel is ``csrc/dual_branch.cu`` (CUDA C++ for
``sm_90a``): one grid of FFN blocks (each a 64-column tile of F for all B
rows, partials summed in tile order by a second small launch) beside
attention blocks.  What bounds it on an H100: bytes, the FFN weights above
all (151 MB at llama3.2-3b in bf16).  The FFN is computed with fp32 sums and
one rounding at each output, as the TPU kernel computes it.

bf16 q, x, weights and pages (the serving path's types) run the FFN on the
tensor cores (a TMA ring of weight boxes, ``mma.sync`` with the weights as
the A operand and the batch as N, h fed to wo as a bf16 hi/lo pair, tile
partials summed in ``FFN_SUM_CHUNKS`` chunks of tiles) and the attention as
the decode kernel's key-split items (``csrc/paged_decode_splits.cuh``);
fp32 inputs or pools keep the CUDA-core FFN blocks beside the attention
block of ``csrc/paged_common.cuh``.

``fused_dual_branch_decode`` runs the plain version for CPU tensors and the
kernel for CUDA tensors; on a CUDA tensor it launches the kernel or raises.
On ``meta`` tensors it takes the meta route (``kernels/meta.py``): the
outputs and the CUDA route's workspace (``workspace_size``), the attention's
4 D flops a table key a query head plus the FFN's 2 Dm F a matrix a lane.
``LAUNCHES_FUSED`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import meta
from repro_torch.kernels import paged_attention as _pa
from repro_torch.models import layers as L

#: kernel launches since the last ``reset_launches()``
LAUNCHES_FUSED = 0

KINDS = ("swiglu", "geglu", "gelu")
#: F columns per FFN block of the kernel (``kFT`` in ``csrc/dual_branch.cu``)
FFN_TILE = 64
#: chunks of tiles the bf16 route sums in order, then adds in chunk order
#: (``kSumChunks``)
FFN_SUM_CHUNKS = 8


def reset_launches():
    global LAUNCHES_FUSED
    LAUNCHES_FUSED = 0


def fused_dual_branch_decode_plain(q, k_pages, v_pages, block_tables,
                                   seq_lens, x, ffn, *, kind="swiglu",
                                   scale=None):
    """The oracle of ``tests/test_dual_branch.py:225-244``: the plain paged
    decode attention, then ``layers.mlp_apply`` on the (B, 1, Dm) rows.
    q (B, H, D); x (B, Dm); ffn {"wi" (Dm, F)[, "wg"], "wo" (F, Dm)} ->
    (attn (B, H, D), y (B, Dm)).  ``mlp_apply`` works in x's dtype, so in
    bfloat16 it rounds where the kernel keeps fp32; the caller compares in
    fp32 or within a bf16 rounding."""
    attn = _pa.paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                            seq_lens, scale=scale)
    return attn, L.mlp_apply(ffn, x[:, None], kind)[:, 0]


def _lib():
    from repro_torch.kernels import build
    lib = build.load("dual_branch")
    fn = lib.fused_dual_branch_decode
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # q, k, v, bt, seq_lens, x, wi, wg, wo, out, y, workspace; B, H,
        # Hkv, D, page, Tb, Dm, F, kind; scale; q_bf16, kv_bf16, device;
        # stream; workspace bytes
        fn.argtypes = [vp] * 12 + [i] * 9 + [ctypes.c_float] + [i] * 3 \
            + [vp, ctypes.c_longlong]
        fn.restype = i
        lib.fused_dual_branch_workspace_bytes.argtypes = [i] * 10
        lib.fused_dual_branch_workspace_bytes.restype = ctypes.c_longlong
        lib.dual_branch_error_string.argtypes = [i]
        lib.dual_branch_error_string.restype = ctypes.c_char_p
    return lib


def check_kernel_args(q, k_pages, v_pages, block_tables, seq_lens, x, ffn,
                      kind):
    """Raise on anything the fused kernel does not take: the decode
    kernel's checks, plus x (B, Dm) and the FFN weights contiguous on q's
    device in q's dtype."""
    _pa.check_decode_args(q, k_pages, v_pages, block_tables, seq_lens)
    if kind not in KINDS:
        raise ValueError(f"fused_dual_branch_decode kernel: kind {kind!r} "
                         f"not in {KINDS}")
    names = ("wi", "wg", "wo") if kind != "gelu" else ("wi", "wo")
    B, Dm = q.shape[0], x.shape[-1]
    F = ffn["wi"].shape[-1]
    shapes = {"x": (B, Dm), "wi": (Dm, F), "wg": (Dm, F), "wo": (F, Dm)}
    for name in ("x",) + names:
        t = x if name == "x" else ffn[name]
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"fused_dual_branch_decode kernel: {name} must "
                             f"be contiguous on {q.device} in {q.dtype}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_dual_branch_decode kernel: {name} is "
                             f"{tuple(t.shape)}, expected {shapes[name]}")


def fused_dual_branch_decode_cuda(q, k_pages, v_pages, block_tables,
                                  seq_lens, x, ffn, *, kind="swiglu",
                                  scale=None):
    """Launch the fused kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES_FUSED
    check_kernel_args(q, k_pages, v_pages, block_tables, seq_lens, x, ffn,
                      kind)
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    Dm, F = ffn["wi"].shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    y = torch.empty_like(x)
    if B == 0:
        return out, y
    Tb = block_tables.shape[1]
    dtypes = (int(q.dtype == torch.bfloat16),
              int(k_pages.dtype == torch.bfloat16))
    wg = ffn["wg"].data_ptr() if kind != "gelu" else None
    lib = _lib()
    # the FFN tiles' fp32 partials (and on the bf16 route the attention
    # splits' partials)
    ws = torch.empty(lib.fused_dual_branch_workspace_bytes(
        B, H, Hkv, D, page, Tb, Dm, F, *dtypes), dtype=torch.uint8,
        device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fused_dual_branch_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), x.data_ptr(),
        ffn["wi"].data_ptr(), wg, ffn["wo"].data_ptr(), out.data_ptr(),
        y.data_ptr(), ws.data_ptr(), B, H, Hkv, D, page, Tb, Dm, F,
        KINDS.index(kind), float(scale), *dtypes, q.device.index, stream,
        ws.numel())
    if err != 0:
        msg = lib.dual_branch_error_string(err).decode()
        raise RuntimeError(f"fused_dual_branch_decode kernel launch failed "
                           f"({err}): {msg}")
    LAUNCHES_FUSED += 1
    return out, y


def workspace_size(B, H, D, page, Tb, Dm, F, q_bf16, kv_bf16):
    """``fused_dual_branch_workspace_bytes`` (``csrc/dual_branch.cu``): on
    the bf16 route the decode splits' partials, then from a 16-byte
    boundary the FFN tiles' fp32 partials a chunk of 8 lanes; else the
    CUDA-core FFN's scratch."""
    tiles = -(-F // FFN_TILE)
    if q_bf16 and kv_bf16:
        attn = _pa.decode_workspace_size(B, H, D, page, Tb)
        return (attn + 15) // 16 * 16 + tiles * (-(-B // 8)) * Dm * 8 * 4
    return tiles * B * Dm * 4


def fused_dual_branch_decode_meta(q, k_pages, v_pages, block_tables,
                                  seq_lens, x, ffn, *, kind="swiglu",
                                  scale=None):
    """The meta route: (attn, y) and the workspace, as the CUDA route
    allocates them."""
    B, H, D = q.shape
    Dm, F = ffn["wi"].shape
    out, y = torch.empty_like(q), torch.empty_like(x)
    if B:
        torch.empty(workspace_size(
            B, H, D, k_pages.shape[1], block_tables.shape[1], Dm, F,
            q.dtype == torch.bfloat16, k_pages.dtype == torch.bfloat16),
            dtype=torch.uint8, device=q.device)
    keys = block_tables.shape[1] * k_pages.shape[1]
    mats = 2 if kind == "gelu" else 3
    meta.add("fused_dual_branch_decode",
             4 * D * keys * H * B + 2 * Dm * F * mats * B,
             (q, k_pages, v_pages, block_tables, seq_lens, x,
              *ffn.values()), (out, y))
    return out, y


def fused_dual_branch_decode(q, k_pages, v_pages, block_tables, seq_lens, x,
                             ffn, *, kind="swiglu", scale=None):
    """Fused dual-branch decode: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (never the plain version there), the meta
    route for ``meta`` tensors.  q (B, H,
    D); x (B, Dm) -> (attn (B, H, D), y (B, Dm))."""
    fn = meta.route(q, fused_dual_branch_decode_plain,
                    fused_dual_branch_decode_meta,
                    fused_dual_branch_decode_cuda)
    return fn(q, k_pages, v_pages, block_tables, seq_lens, x, ffn, kind=kind,
              scale=scale)
