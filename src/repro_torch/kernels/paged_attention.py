"""Packed ragged paged attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py:346``
``paged_packed_attention`` (body ``_paged_packed_kernel``, ``:292``); the
plain version is ``repro/kernels/ref.py:119`` ``paged_packed_attention_ref``
ported.  The kernel is ``csrc/paged_attention.cu`` (CUDA C++ for
``sm_90a``).

What bounds it on an H100: bytes.  Each token reads the K and V rows of its
own pages up to its position, once for all G query heads of a KV head, and
does about 6 flops per byte read at G = 3, far below the tensor cores' knee.
One thread block per (token, KV head) holds the G query rows in registers,
walks the token's pages in a loop with 16-byte vector loads and never
touches a page past the token's position (see the source's header).

``paged_packed_attention`` runs the plain version for CPU tensors and the
kernel for CUDA tensors; on a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

#: kernel launches since the last ``reset_launches()``
LAUNCHES = 0

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


def paged_packed_attention_plain(q, k_pages, v_pages, block_tables, tok_slot,
                                 tok_pos, *, scale=None):
    """Gather-based packed paged attention (``ref.py:119``): q (T, H, D),
    pools (P, page, Hkv, D), block_tables (S, Tb), tok_slot/tok_pos (T,)
    -> (T, H, D) in q's dtype.  Token t sees the keys of its own slot's
    table at gathered index ``j <= tok_pos[t]``; ``tok_pos == -1`` rows
    return 0."""
    T, H, D = q.shape
    Hkv = k_pages.shape[2]
    G = H // Hkv
    Dv = v_pages.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    bt = block_tables[tok_slot.long()].long()               # (T, Tb)
    k = k_pages[bt].reshape(T, -1, Hkv, D).float()          # (T, Sk, Hkv, D)
    v = v_pages[bt].reshape(T, -1, Hkv, Dv).float()
    qg = q.reshape(T, Hkv, G, D).float()
    s = torch.einsum("thgd,tkhd->thgk", qg, k) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)[None]  # (1, Sk)
    mask = k_pos <= tok_pos[:, None]                         # (T, Sk)
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, None], p, 0.0)
    o = torch.einsum("thgk,tkhd->thgd", p, v)
    return o.reshape(T, H, Dv).to(q.dtype)


def _lib():
    from repro_torch.kernels import build
    lib = build.load("paged_attention")
    fn = lib.paged_packed_attention
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                       ctypes.c_float, i, i, i, vp]
        fn.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_kernel_args(q, k_pages, v_pages, block_tables, tok_slot, tok_pos):
    """Raise on anything the CUDA kernel does not take."""
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "tok_slot": tok_slot,
               "tok_pos": tok_pos}
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"paged_packed_attention kernel: {name} is on "
                             f"{x.device}; the kernel takes CUDA tensors")
        if x.device != q.device:
            raise ValueError(f"paged_packed_attention kernel: {name} is on "
                             f"{x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"paged_packed_attention kernel: {name} is not "
                             f"contiguous")
    for name in ("block_tables", "tok_slot", "tok_pos"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"paged_packed_attention kernel: {name} must be "
                             f"int32, got {tensors[name].dtype}")
    if q.dtype not in _KERNEL_DTYPES or k_pages.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"paged_packed_attention kernel: q/pool dtypes "
                         f"{q.dtype}/{k_pages.dtype} not in bfloat16/float32")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError("paged_packed_attention kernel: v_pages must match "
                         "k_pages in shape and dtype")
    T, H, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    if D not in HEAD_DIMS or Dk != D:
        raise ValueError(f"paged_packed_attention kernel: head dim {D} "
                         f"(pool {Dk}) not in {HEAD_DIMS}")
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"paged_packed_attention kernel: H={H}, Hkv={Hkv} "
                         f"needs H % Hkv == 0 and H / Hkv <= {MAX_GROUP}")
    if tok_slot.shape != (T,) or tok_pos.shape != (T,) \
            or block_tables.dim() != 2:
        raise ValueError("paged_packed_attention kernel: tok_slot/tok_pos "
                         "must be (T,) and block_tables (S, Tb)")
    for name in ("k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"paged_packed_attention kernel: {name} is not "
                             f"16-byte aligned")


def paged_packed_attention_cuda(q, k_pages, v_pages, block_tables, tok_slot,
                                tok_pos, *, scale=None):
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES
    check_kernel_args(q, k_pages, v_pages, block_tables, tok_slot, tok_pos)
    T, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if T == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_packed_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), tok_slot.data_ptr(), tok_pos.data_ptr(),
        out.data_ptr(), T, H, Hkv, D, page, block_tables.shape[1],
        float(scale), int(q.dtype == torch.bfloat16),
        int(k_pages.dtype == torch.bfloat16), q.device.index, stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_packed_attention kernel launch failed "
                           f"({err}): {msg}")
    LAUNCHES += 1
    return out


def paged_packed_attention(q, k_pages, v_pages, block_tables, tok_slot,
                           tok_pos, *, scale=None, k_scale=None,
                           v_scale=None):
    """Packed ragged paged attention: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (never the plain version there)."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "paged_packed_attention: int8/fp8 scale pools come with the "
            "quantized-KV slice of the PyTorch port")
    if q.device.type == "cpu":
        return paged_packed_attention_plain(q, k_pages, v_pages, block_tables,
                                            tok_slot, tok_pos, scale=scale)
    return paged_packed_attention_cuda(q, k_pages, v_pages, block_tables,
                                       tok_slot, tok_pos, scale=scale)
