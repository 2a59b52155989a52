"""Paged attention in the packed, decode and chunk layouts: the CUDA
kernels' wrappers and their plain PyTorch versions.

Replaces three Pallas TPU kernels of ``repro/kernels/paged_attention.py``:

* ``paged_packed_attention`` (``:346``, body ``_paged_packed_kernel``
  ``:292``): a flat (T,) token buffer, token t of slot ``tok_slot[t]`` at
  ``tok_pos[t]``; plain version ``repro/kernels/ref.py:119``.
* ``paged_decode_attention`` (``:106``, body ``_paged_kernel`` ``:53``):
  one query per lane over keys ``j < seq_lens[b]``; plain version
  ``ref.py:45``.
* ``paged_chunk_attention`` (``:222``, body ``_paged_chunk_kernel``
  ``:161``): a (B, C) chunk per lane at ``pos``, causal in the chunk over
  the lane's live history ``j < pos + n_valid``; plain version ``ref.py:76``.

The kernels are ``csrc/paged_attention.cu`` (CUDA C++ for ``sm_90a``), one
source with three entry points over the shared attention block of
``csrc/paged_common.cuh``.  What bounds them on an H100: bytes.  Each query
row reads the K and V rows of its own pages up to its last visible key,
once for all G query heads of a KV head, and does about 6 flops per byte at
G = 3.  One thread block per (query row, KV head) holds the G query rows in
registers, walks the pages in a loop with 16-byte vector loads and never
touches a page past the last visible key (see the sources' headers).

Each public function runs the plain version for CPU tensors and the kernel
for CUDA tensors; on a CUDA tensor it launches the kernel or raises.  Each
kernel has its own launch counter (``LAUNCHES_PACKED``, ``LAUNCHES_DECODE``,
``LAUNCHES_CHUNK``), raised by one where the wrapper launches it and
nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

#: kernel launches since the last ``reset_launches()``, one per kernel
LAUNCHES_PACKED = 0
LAUNCHES_DECODE = 0
LAUNCHES_CHUNK = 0

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def reset_launches():
    global LAUNCHES_PACKED, LAUNCHES_DECODE, LAUNCHES_CHUNK
    LAUNCHES_PACKED = LAUNCHES_DECODE = LAUNCHES_CHUNK = 0


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def _gather(q, k_pages, v_pages, bt):
    """Per-row gathered pools (N, Sk, Hkv, D) in fp32 for table rows ``bt``
    (N, Tb), and the scale."""
    n = bt.shape[0]
    Hkv, D = k_pages.shape[2], q.shape[-1]
    k = k_pages[bt.long()].reshape(n, -1, Hkv, D).float()
    v = v_pages[bt.long()].reshape(n, -1, Hkv, v_pages.shape[-1]).float()
    return k, v


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
    scale = D ** -0.5 if scale is None else scale
    k, v = _gather(q, k_pages, v_pages, block_tables[tok_slot.long()])
    qg = q.reshape(T, Hkv, G, D).float()
    s = torch.einsum("thgd,tkhd->thgk", qg, k) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)[None]  # (1, Sk)
    mask = k_pos <= tok_pos[:, None]                         # (T, Sk)
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, None], p, 0.0)
    o = torch.einsum("thgk,tkhd->thgd", p, v)
    return o.reshape(T, H, v.shape[-1]).to(q.dtype)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                                 *, scale=None):
    """Gather-based paged decode attention (``ref.py:45``): q (B, H, D),
    pools (P, page, Hkv, D), block_tables (B, Tb), seq_lens (B,) -> (B, H,
    D) in q's dtype.  Lane b sees gathered keys ``j < seq_lens[b]``.

    Like ``ref.py`` (and unlike the Pallas and CUDA kernels, which write 0),
    a lane with ``seq_len == 0`` gets the softmax over all -1e30 scores: the
    mean of its gathered V rows.  The model never passes 0 (``seq_lens =
    pos + 1``); tests compare kernel and plain version for ``seq_len >= 1``
    only."""
    B, H, D = q.shape
    Hkv = k_pages.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    k, v = _gather(q, k_pages, v_pages, block_tables)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * scale
    mask = torch.arange(k.shape[1], device=q.device)[None] \
        < seq_lens[:, None]                                  # (B, Sk)
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return o.reshape(B, H, v.shape[-1]).to(q.dtype)


def paged_chunk_attention_plain(q, k_pages, v_pages, block_tables, pos,
                                n_valid, *, scale=None):
    """Gather-based chunked paged attention (``ref.py:76``): q (B, C, H, D)
    at positions ``pos[b] + c``, pools (P, page, Hkv, D), block_tables (B,
    Tb), pos/n_valid (B,) -> (B, C, H, D) in q's dtype.  Row (b, c) sees
    gathered keys ``j <= pos + c`` and ``j < pos + n_valid``; a row with no
    visible key returns 0.  Rows past ``n_valid`` are defined by the same
    rule (finite but meaningless to a caller)."""
    B, C, H, D = q.shape
    Hkv = k_pages.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    k, v = _gather(q, k_pages, v_pages, block_tables)
    qg = q.reshape(B, C, Hkv, G, D).float()
    s = torch.einsum("bchgd,bkhd->bhgck", qg, k) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)[None, None]  # (1,1,Sk)
    q_pos = pos[:, None] + torch.arange(C, device=q.device)[None]  # (B, C)
    seq_len = (pos + n_valid)[:, None, None]
    mask = (k_pos <= q_pos[:, :, None]) & (k_pos < seq_len)        # (B,C,Sk)
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, :, None], p, 0.0)
    o = torch.einsum("bhgck,bkhd->bchgd", p, v)
    return o.reshape(B, C, H, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #
def _lib():
    from repro_torch.kernels import build
    lib = build.load("paged_attention")
    if lib.paged_packed_attention.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [f, i, i, i, vp]            # scale, q_bf16, kv_bf16, dev, stream
        lib.paged_packed_attention.argtypes = \
            [vp] * 7 + [i] * 6 + tail      # ..., T, H, Hkv, D, page, Tb
        lib.paged_decode_attention.argtypes = \
            [vp] * 6 + [i] * 6 + tail      # ..., B, H, Hkv, D, page, Tb
        lib.paged_chunk_attention.argtypes = \
            [vp] * 7 + [i] * 7 + tail      # ..., B, C, H, Hkv, D, page, Tb
        for fn in (lib.paged_packed_attention, lib.paged_decode_attention,
                   lib.paged_chunk_attention):
            fn.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_pools(kernel, q, k_pages, v_pages, index_tensors):
    """Raise on anything a paged kernel does not take: q (..., H, D) and
    pools (P, page, Hkv, D) in bfloat16 / float32 on one CUDA device,
    contiguous, int32 index tensors, D in ``HEAD_DIMS``, 1 <= H / Hkv <=
    ``MAX_GROUP``, 16-byte aligned pools."""
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               **index_tensors}
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{kernel} kernel: {name} is on {x.device}; "
                             f"the kernel takes CUDA tensors")
        if x.device != q.device:
            raise ValueError(f"{kernel} kernel: {name} is on {x.device}, q "
                             f"on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} is not contiguous")
    for name, x in index_tensors.items():
        if x.dtype != torch.int32:
            raise ValueError(f"{kernel} kernel: {name} must be int32, got "
                             f"{x.dtype}")
    if q.dtype not in _KERNEL_DTYPES or k_pages.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{kernel} kernel: q/pool dtypes {q.dtype}/"
                         f"{k_pages.dtype} not in bfloat16/float32")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape \
            or k_pages.dim() != 4:
        raise ValueError(f"{kernel} kernel: pools must be (P, page, Hkv, D) "
                         f"and v_pages must match k_pages in shape and dtype")
    H, D = q.shape[-2:]
    Hkv, Dk = k_pages.shape[2:]
    if D not in HEAD_DIMS or Dk != D:
        raise ValueError(f"{kernel} kernel: head dim {D} (pool {Dk}) not in "
                         f"{HEAD_DIMS}")
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{kernel} kernel: H={H}, Hkv={Hkv} needs H % Hkv "
                         f"== 0 and H / Hkv <= {MAX_GROUP}")
    for name in ("k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{kernel} kernel: {name} is not 16-byte "
                             f"aligned")


def check_kernel_args(q, k_pages, v_pages, block_tables, tok_slot, tok_pos):
    """Raise on anything the packed kernel does not take."""
    check_pools("paged_packed_attention", q, k_pages, v_pages,
                {"block_tables": block_tables, "tok_slot": tok_slot,
                 "tok_pos": tok_pos})
    T = q.shape[0]
    if q.dim() != 3 or tok_slot.shape != (T,) or tok_pos.shape != (T,) \
            or block_tables.dim() != 2:
        raise ValueError("paged_packed_attention kernel: q must be (T, H, "
                         "D), tok_slot/tok_pos (T,) and block_tables (S, Tb)")


def check_decode_args(q, k_pages, v_pages, block_tables, seq_lens):
    """Raise on anything the decode kernel does not take."""
    check_pools("paged_decode_attention", q, k_pages, v_pages,
                {"block_tables": block_tables, "seq_lens": seq_lens})
    B = q.shape[0]
    if q.dim() != 3 or seq_lens.shape != (B,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError("paged_decode_attention kernel: q must be (B, H, "
                         "D), seq_lens (B,) and block_tables (B, Tb)")


def check_chunk_args(q, k_pages, v_pages, block_tables, pos, n_valid):
    """Raise on anything the chunk kernel does not take."""
    check_pools("paged_chunk_attention", q, k_pages, v_pages,
                {"block_tables": block_tables, "pos": pos,
                 "n_valid": n_valid})
    B = q.shape[0]
    if q.dim() != 4 or pos.shape != (B,) or n_valid.shape != (B,) \
            or block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("paged_chunk_attention kernel: q must be (B, C, H, "
                         "D), pos/n_valid (B,) and block_tables (B, Tb)")


def _launch(lib, fn, q, k_pages, *args):
    """Call a C entry point with the dtype flags, device and current stream
    appended; raise on a non-zero return."""
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, fn)(*args, int(q.dtype == torch.bfloat16),
                           int(k_pages.dtype == torch.bfloat16),
                           q.device.index, stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed ({err}): {msg}")


def paged_packed_attention_cuda(q, k_pages, v_pages, block_tables, tok_slot,
                                tok_pos, *, scale=None):
    """Launch the packed kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES_PACKED
    check_kernel_args(q, k_pages, v_pages, block_tables, tok_slot, tok_pos)
    T, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if T == 0:
        return out
    _launch(_lib(), "paged_packed_attention", q, k_pages,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), tok_slot.data_ptr(), tok_pos.data_ptr(),
            out.data_ptr(), T, H, Hkv, D, page, block_tables.shape[1],
            float(scale))
    LAUNCHES_PACKED += 1
    return out


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                                *, scale=None):
    """Launch the decode kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES_DECODE
    check_decode_args(q, k_pages, v_pages, block_tables, seq_lens)
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if B == 0:
        return out
    _launch(_lib(), "paged_decode_attention", q, k_pages,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, H, Hkv, D, page, block_tables.shape[1], float(scale))
    LAUNCHES_DECODE += 1
    return out


def paged_chunk_attention_cuda(q, k_pages, v_pages, block_tables, pos,
                               n_valid, *, scale=None):
    """Launch the chunk kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES_CHUNK
    check_chunk_args(q, k_pages, v_pages, block_tables, pos, n_valid)
    B, C, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if B * C == 0:
        return out
    _launch(_lib(), "paged_chunk_attention", q, k_pages,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(), n_valid.data_ptr(),
            out.data_ptr(), B, C, H, Hkv, D, page, block_tables.shape[1],
            float(scale))
    LAUNCHES_CHUNK += 1
    return out


# --------------------------------------------------------------------------- #
# public entry points: plain version on the CPU, kernel on the card
# --------------------------------------------------------------------------- #
def _no_scales(kernel, k_scale, v_scale):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            f"{kernel}: int8/fp8 scale pools come with the quantized-KV "
            f"slice of the PyTorch port")


def paged_packed_attention(q, k_pages, v_pages, block_tables, tok_slot,
                           tok_pos, *, scale=None, k_scale=None,
                           v_scale=None):
    """Packed ragged paged attention: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (never the plain version there)."""
    _no_scales("paged_packed_attention", k_scale, v_scale)
    fn = paged_packed_attention_plain if q.device.type == "cpu" \
        else paged_packed_attention_cuda
    return fn(q, k_pages, v_pages, block_tables, tok_slot, tok_pos,
              scale=scale)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           scale=None, k_scale=None, v_scale=None):
    """Paged decode attention: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (never the plain version there)."""
    _no_scales("paged_decode_attention", k_scale, v_scale)
    fn = paged_decode_attention_plain if q.device.type == "cpu" \
        else paged_decode_attention_cuda
    return fn(q, k_pages, v_pages, block_tables, seq_lens, scale=scale)


def paged_chunk_attention(q, k_pages, v_pages, block_tables, pos, n_valid, *,
                          scale=None, k_scale=None, v_scale=None):
    """Chunked paged attention: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (never the plain version there)."""
    _no_scales("paged_chunk_attention", k_scale, v_scale)
    fn = paged_chunk_attention_plain if q.device.type == "cpu" \
        else paged_chunk_attention_cuda
    return fn(q, k_pages, v_pages, block_tables, pos, n_valid, scale=scale)
