"""Paged attention in the packed, decode and chunk layouts, and the
copy-on-write page copy: the CUDA kernels' wrappers and their plain PyTorch
versions.

Replaces four Pallas TPU kernels of ``repro/kernels/paged_attention.py``:

* ``paged_packed_attention`` (``:346``, body ``_paged_packed_kernel``
  ``:292``): a flat (T,) token buffer, token t of slot ``tok_slot[t]`` at
  ``tok_pos[t]``; plain version ``repro/kernels/ref.py:119``.
* ``paged_decode_attention`` (``:106``, body ``_paged_kernel`` ``:53``):
  one query per lane over keys ``j < seq_lens[b]``; plain version
  ``ref.py:45``.
* ``paged_chunk_attention`` (``:222``, body ``_paged_chunk_kernel``
  ``:161``): a (B, C) chunk per lane at ``pos``, causal in the chunk over
  the lane's live history ``j < pos + n_valid``; plain version ``ref.py:76``.
* ``page_copy`` (``:420``): in place, the rows of pages ``src[i]`` over
  pages ``dst[i]`` in one (P, page, ...) pool; plain version
  ``ref.py:170``.  The reference's ``copy_paged_pages`` calls it once per
  pool leaf of the cache; the port's kernel takes every leaf, and every
  layer of a stacked leaf, in one launch (``page_copy_leaves``).

Each attention kernel also has its int8 / fp8 scale variant: quantized
(P, page, Hkv, D) pools with (P, page) fp32 ``k_scale`` / ``v_scale`` row
scales, dequantized where a row is loaded (the reference's ``_dequant``).

The attention kernels are ``csrc/paged_attention.cu`` (CUDA C++ for
``sm_90a``), one source with three entry points over the shared attention
block of ``csrc/paged_common.cuh`` (and the two bf16 designs below); the
page copy is ``csrc/page_copy.cu``: one launch a copy-on-write, its leaf
table (base, bytes a page, pages a layer, layers) and page ids in the
launch's parameters, each block one (leaf, layer, pair, 16 KB chunk) task
of 16-byte vectors, four loads in flight a thread.
What bounds them on an H100: bytes.  Each query row reads the K and V rows
of its own pages up to its last visible key, once for all G query heads of a
KV head, and does about 6 flops per byte at G = 3 (12 on quantized pages).
One thread block per (query row, KV head) holds the G query rows in
registers, walks the pages in a loop with vector loads and never touches a
page past the last visible key (see the sources' headers).

The decode kernel with bf16 q on bf16, int8 or fp8 pages (the padded
serving path's pairs) runs key splits with a pipelined gather instead
(``csrc/paged_decode_splits.cuh``): a fixed grid of (lane, KV head, split
of ``split_keys(Tb * page)`` keys) items, each gathering 64-key K/V tiles
(raw bytes and their row scales on one-byte pages) through the block table
by cp.async into a ring and computing in fp32 on the CUDA cores (one-byte
values widened exactly, the scales folded into the scores and into P); a
lane with more than one split is merged by a combine kernel in split order
from fp32 partials in a workspace the wrapper allocates
(``paged_decode_workspace_bytes`` sizes it); fp32 q or fp32 pages keep the
attention block.

The packed kernel with bf16 q on bf16, int8 or fp8 pages (the engine's
type pairs) runs on the tensor cores instead (``csrc/paged_packed_tc.cuh``):
the tokens of a slot that sit side by side form a run; each work item is up
to ``TILE_ROWS // G`` tokens of one run, one KV head and one key split of
``split_keys(Tb * page)`` keys, whose K/V tiles are read once for all its
(token, head) query rows.  A plan kernel writes the work list
(``packed_work_list`` is its plain version) into a workspace the wrapper
allocates, the attention kernel walks it, and a combine kernel merges the
splits in split order; nothing is read back to the host.  One-byte pages
are widened to bf16 exactly in shared memory; their row scales act in fp32
on the score columns (``k_scale``) and on P before its bf16 rounding
(``v_scale``).  fp32 q or fp32 pages keep the attention block.

The chunk kernel with bf16 q on bf16, int8 or fp8 pages (the padded serving
path's prefill) runs the same tensor-core attention kernel over chunk
items instead: ``TILE_ROWS // G`` rows of one lane's chunk, one KV head and
one key split, decoded from the item index (no plan kernel); row (b, c)
keeps its own key limit ``min(pos + c, pos + n_valid - 1)``.  A chunk's
keys are split (``chunk_split_keys``) only when the row-tile items number
fewer than ``CHUNK_SPLIT_ITEMS``; then the combine merges them from a
workspace the wrapper allocates (``paged_chunk_workspace_bytes`` sizes it),
else every item writes its rows directly.

Each public function runs the plain version for CPU tensors and the kernel
for CUDA tensors; on a CUDA tensor it launches the kernel or raises.  On
``meta`` tensors it takes the meta route (``kernels/meta.py``): the
kernel's output and the workspace its CUDA route allocates
(``*_workspace_size``, the sources' layouts in Python), flops counted over
every key of each row's table, since a meta tensor holds no positions.
``LAUNCHES`` counts each kernel's launches under its label (the kernel's
name, ``<name>.int8`` / ``<name>.fp8`` for the scale variants, and
``page_copy``: one a copy-on-write of up to ``COPY_MAX_PAIRS`` pages),
raised by one where the wrapper launches it and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import meta

ATTENTION_KERNELS = ("paged_packed_attention", "paged_decode_attention",
                     "paged_chunk_attention")
#: quantized page storage -> label suffix of the scale variants
KV_VARIANTS = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
#: kernel launches since the last ``reset_launches()``, by kernel label
LAUNCHES = {}

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8
#: query rows of a work item of the tensor-core packed kernel (wgmma's m64)
TILE_ROWS = 64
#: keys of a K/V tile of the tensor-core packed kernel; splits are multiples
TILE_KEYS = 64
#: keys of a split of the tensor-core packed kernel, at least; splits of a
#: table, at most
MIN_SPLIT_KEYS, MAX_SPLITS = 256, 8
#: the tensor-core chunk route splits keys only below this many row-tile
#: items (lanes x row tiles x KV heads; experiments/torch_chunk_splits.py)
CHUNK_SPLIT_ITEMS = 128
#: page pairs and pool leaves of one page-copy launch, at most
#: (``csrc/page_copy.cu``'s kMaxPairs and kMaxLeaves: the pairs and the
#: leaf table ride in the launch's parameter block; a cache has at most 8
#: leaves, so only the pairs are split)
COPY_MAX_PAIRS, COPY_MAX_LEAVES = 256, 16
_Q_DTYPES = (torch.bfloat16, torch.float32)
#: the kernels' ``kv_type`` codes (``csrc/paged_attention.cu``)
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}


def kernel_label(kernel, k_pages, k_scale):
    """``kernel`` for bf16 / fp32 pools, ``kernel.int8`` / ``kernel.fp8``
    when scale pools come with quantized pages."""
    if k_scale is None:
        return kernel
    name = KV_VARIANTS.get(k_pages.dtype, str(k_pages.dtype)[len("torch."):])
    return f"{kernel}.{name}"


def reset_launches():
    LAUNCHES.clear()
    for kernel in ATTENTION_KERNELS:
        LAUNCHES[kernel] = 0
        for suffix in KV_VARIANTS.values():
            LAUNCHES[f"{kernel}.{suffix}"] = 0
    LAUNCHES["page_copy"] = 0


reset_launches()


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def _gather(k_pages, v_pages, bt, k_scale=None, v_scale=None):
    """Per-row gathered pools (N, Sk, Hkv, D) in fp32 for table rows ``bt``
    (N, Tb), each row times its (P, page) scale when scales are given
    (``ref.py``'s ``_dequant``)."""
    n, idx = bt.shape[0], bt.long()

    def rows(pages, scales):
        x = pages[idx].reshape((n, -1) + tuple(pages.shape[2:])).float()
        if scales is None:
            return x
        return x * scales[idx].reshape(n, -1)[..., None, None].float()

    return rows(k_pages, k_scale), rows(v_pages, v_scale)


def paged_packed_attention_plain(q, k_pages, v_pages, block_tables, tok_slot,
                                 tok_pos, *, scale=None, k_scale=None,
                                 v_scale=None):
    """Gather-based packed paged attention (``ref.py:119``): q (T, H, D),
    pools (P, page, Hkv, D), block_tables (S, Tb), tok_slot/tok_pos (T,)
    -> (T, H, D) in q's dtype.  Token t sees the keys of its own slot's
    table at gathered index ``j <= tok_pos[t]``; ``tok_pos == -1`` rows
    return 0.  Optional (P, page) ``k_scale`` / ``v_scale`` dequantize
    int8 / fp8 pools row by row (likewise in the two functions below)."""
    T, H, D = q.shape
    Hkv = k_pages.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    k, v = _gather(k_pages, v_pages, block_tables[tok_slot.long()],
                   k_scale, v_scale)
    qg = q.reshape(T, Hkv, G, D).float()
    s = torch.einsum("thgd,tkhd->thgk", qg, k) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)[None]  # (1, Sk)
    mask = k_pos <= tok_pos[:, None]                         # (T, Sk)
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, None], p, 0.0)
    o = torch.einsum("thgk,tkhd->thgd", p, v)
    return o.reshape(T, H, v.shape[-1]).to(q.dtype)


def split_keys(max_keys):
    """Keys of a split of the tensor-core packed kernel and of the bf16
    key-split decode kernel for a table of ``max_keys = Tb * page`` keys:
    at least ``MIN_SPLIT_KEYS``, at most ``MAX_SPLITS`` splits, a multiple
    of ``TILE_KEYS`` (``split_keys`` of ``csrc/paged_packed_tc.cuh`` and
    ``csrc/paged_decode_splits.cuh``)."""
    per = -(-max_keys // MAX_SPLITS)
    return max(MIN_SPLIT_KEYS, -(-per // TILE_KEYS) * TILE_KEYS)


def chunk_split_keys(B, C, *, G, Hkv, max_keys):
    """Keys of a split of the tensor-core chunk route (``chunk_plan`` of
    ``csrc/paged_packed_tc.cuh``): ``split_keys(max_keys)`` when the
    row-tile items, ``B * ceil(C / (TILE_ROWS // G)) * Hkv``, number fewer
    than ``CHUNK_SPLIT_ITEMS``, else the whole table in one split.  It reads
    shapes only, never the device."""
    tiles = -(-C // (TILE_ROWS // G))
    if B * tiles * Hkv < CHUNK_SPLIT_ITEMS:
        return split_keys(max_keys)
    return max_keys


def _partials_end(ml, parts, D):
    """End of ``partials_layout`` (``csrc/paged_packed_tc.cuh``): ``parts``
    (m, l) float2 from byte ``ml``, then the fp32 accumulators from the
    next 16-byte boundary."""
    if not parts:
        return ml
    return (ml + 8 * parts + 15) // 16 * 16 + 4 * parts * D


def _split_route(q, k_pages):
    """Whether the split routes (and their workspaces) run: bf16 q on bf16,
    int8 or fp8 pages."""
    return q.dtype == torch.bfloat16 and k_pages.dtype != torch.float32


def packed_workspace_size(T, H, Hkv, D, page, Tb):
    """``paged_packed_workspace_bytes`` of the tensor-core route: the count,
    ``T * splits * Hkv`` items, and the partials when a chunk can have
    more than one split."""
    max_keys = Tb * page
    splits = -(-max_keys // split_keys(max_keys))
    parts = splits * T * H if splits > 1 else 0
    return _partials_end(16 + 16 * T * splits * Hkv, parts, D)


def decode_workspace_size(B, H, D, page, Tb):
    """``paged_decode_workspace_bytes`` of the key-split route
    (``workspace_layout`` of ``csrc/paged_decode_splits.cuh``)."""
    max_keys = Tb * page
    splits = -(-max_keys // split_keys(max_keys))
    return _partials_end(0, splits * B * H if splits > 1 else 0, D)


def chunk_workspace_size(B, C, H, Hkv, D, page, Tb):
    """``paged_chunk_workspace_bytes`` of the tensor-core chunk route
    (``chunk_plan``)."""
    max_keys = Tb * page
    L = chunk_split_keys(B, C, G=H // Hkv, Hkv=Hkv, max_keys=max_keys)
    splits = -(-max_keys // L)
    return _partials_end(0, splits * B * C * H if splits > 1 else 0, D)


def packed_work_list(tok_slot, tok_pos, *, G, Hkv, page, Tb):
    """The tensor-core packed kernel's work list, as its plan kernel writes
    it: an int32 (n, 4) tensor of items (first token, tokens, split, KV head).

    A run is a maximal stretch of consecutive tokens of one slot at
    consecutive positions, ``tok_pos >= 0``; padding is in no run.  Each run
    is cut into chunks of ``TILE_ROWS // G`` tokens from its first token on;
    a chunk's keys (up to its last token's position, at most ``Tb * page``)
    into splits of ``split_keys(Tb * page)`` keys; items go chunk by chunk,
    split by split, KV head by KV head."""
    slots, poss = tok_slot.tolist(), tok_pos.tolist()
    R, max_keys = TILE_ROWS // G, Tb * page
    L = split_keys(max_keys)
    items, t = [], 0
    while t < len(poss):
        if poss[t] < 0:
            t += 1
            continue
        end = t + 1                                  # the run is t .. end-1
        while end < len(poss) and slots[end] == slots[t] \
                and poss[end] == poss[end - 1] + 1:
            end += 1
        for t0 in range(t, end, R):
            n = min(R, end - t0)
            keys = min(poss[t0 + n - 1] + 1, max_keys)
            items += [(t0, n, s, hk) for s in range(-(-keys // L))
                      for hk in range(Hkv)]
        t = end
    return torch.tensor(items, dtype=torch.int32).reshape(-1, 4)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                                 *, scale=None, k_scale=None, v_scale=None):
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
    k, v = _gather(k_pages, v_pages, block_tables, k_scale, v_scale)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * scale
    mask = torch.arange(k.shape[1], device=q.device)[None] \
        < seq_lens[:, None]                                  # (B, Sk)
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return o.reshape(B, H, v.shape[-1]).to(q.dtype)


def paged_chunk_attention_plain(q, k_pages, v_pages, block_tables, pos,
                                n_valid, *, scale=None, k_scale=None,
                                v_scale=None):
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
    k, v = _gather(k_pages, v_pages, block_tables, k_scale, v_scale)
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
        tail = [f, i, i, i, vp]        # scale, q_bf16, kv_type, dev, stream
        lib.paged_packed_attention.argtypes = \
            [vp] * 9 + [i] * 6 + tail + [vp, ctypes.c_longlong]
        # ..., T, H, Hkv, D, page, Tb, <tail>, workspace, its bytes
        lib.paged_packed_workspace_bytes.argtypes = [i] * 8
        lib.paged_packed_workspace_bytes.restype = ctypes.c_longlong
        lib.paged_packed_plan.argtypes = \
            [vp] * 2 + [i] * 6 + [vp, ctypes.c_longlong, i, vp]
        lib.paged_packed_plan.restype = i
        lib.paged_decode_attention.argtypes = \
            [vp] * 8 + [i] * 6 + tail + [vp, ctypes.c_longlong]
        # ..., B, H, Hkv, D, page, Tb, <tail>, workspace, its bytes
        lib.paged_decode_workspace_bytes.argtypes = [i] * 8
        lib.paged_decode_workspace_bytes.restype = ctypes.c_longlong
        lib.paged_chunk_attention.argtypes = \
            [vp] * 9 + [i] * 7 + tail + [vp, ctypes.c_longlong]
        # ..., B, C, H, Hkv, D, page, Tb, <tail>, workspace, its bytes
        lib.paged_chunk_workspace_bytes.argtypes = [i] * 9
        lib.paged_chunk_workspace_bytes.restype = ctypes.c_longlong
        for fn in (lib.paged_packed_attention, lib.paged_decode_attention,
                   lib.paged_chunk_attention):
            fn.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_device(kernel, tensors, device):
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{kernel} kernel: {name} is on {x.device}; "
                             f"the kernel takes CUDA tensors")
        if x.device != device:
            raise ValueError(f"{kernel} kernel: {name} is on {x.device}, "
                             f"not {device}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} is not contiguous")


def check_pools(kernel, q, k_pages, v_pages, index_tensors, k_scale=None,
                v_scale=None):
    """Raise on anything a paged kernel does not take: q (..., H, D) in
    bfloat16 / float32 and pools (P, page, Hkv, D) in bfloat16 / float32,
    or int8 / float8_e4m3fn with (P, page) float32 ``k_scale`` and
    ``v_scale`` (and no scales otherwise), all on one CUDA device,
    contiguous, int32 index tensors, D in ``HEAD_DIMS``, 1 <= H / Hkv <=
    ``MAX_GROUP``, 16-byte aligned pools."""
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               **index_tensors}
    scales = {"k_scale": k_scale, "v_scale": v_scale}
    _check_device(kernel, {**tensors, **{n: x for n, x in scales.items()
                                         if x is not None}}, q.device)
    for name, x in index_tensors.items():
        if x.dtype != torch.int32:
            raise ValueError(f"{kernel} kernel: {name} must be int32, got "
                             f"{x.dtype}")
    if q.dtype not in _Q_DTYPES or k_pages.dtype not in _KV_TYPES:
        raise ValueError(f"{kernel} kernel: q/pool dtypes {q.dtype}/"
                         f"{k_pages.dtype} not in bfloat16/float32 (q) and "
                         f"{list(_KV_TYPES)} (pools)")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape \
            or k_pages.dim() != 4:
        raise ValueError(f"{kernel} kernel: pools must be (P, page, Hkv, D) "
                         f"and v_pages must match k_pages in shape and dtype")
    quantized = k_pages.dtype in KV_VARIANTS
    for name, x in scales.items():
        if (x is not None) != quantized:
            raise ValueError(f"{kernel} kernel: {k_pages.dtype} pools "
                             f"{'need' if quantized else 'take no'} {name}")
        if x is not None and (x.dtype != torch.float32
                              or x.shape != k_pages.shape[:2]):
            raise ValueError(f"{kernel} kernel: {name} must be float32 "
                             f"{tuple(k_pages.shape[:2])}, got {x.dtype} "
                             f"{tuple(x.shape)}")
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


def check_kernel_args(q, k_pages, v_pages, block_tables, tok_slot, tok_pos,
                      k_scale=None, v_scale=None):
    """Raise on anything the packed kernel does not take."""
    check_pools("paged_packed_attention", q, k_pages, v_pages,
                {"block_tables": block_tables, "tok_slot": tok_slot,
                 "tok_pos": tok_pos}, k_scale, v_scale)
    T = q.shape[0]
    if q.dim() != 3 or tok_slot.shape != (T,) or tok_pos.shape != (T,) \
            or block_tables.dim() != 2:
        raise ValueError("paged_packed_attention kernel: q must be (T, H, "
                         "D), tok_slot/tok_pos (T,) and block_tables (S, Tb)")


def check_decode_args(q, k_pages, v_pages, block_tables, seq_lens,
                      k_scale=None, v_scale=None):
    """Raise on anything the decode kernel does not take."""
    check_pools("paged_decode_attention", q, k_pages, v_pages,
                {"block_tables": block_tables, "seq_lens": seq_lens},
                k_scale, v_scale)
    B = q.shape[0]
    if q.dim() != 3 or seq_lens.shape != (B,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError("paged_decode_attention kernel: q must be (B, H, "
                         "D), seq_lens (B,) and block_tables (B, Tb)")


def check_chunk_args(q, k_pages, v_pages, block_tables, pos, n_valid,
                     k_scale=None, v_scale=None):
    """Raise on anything the chunk kernel does not take."""
    check_pools("paged_chunk_attention", q, k_pages, v_pages,
                {"block_tables": block_tables, "pos": pos,
                 "n_valid": n_valid}, k_scale, v_scale)
    B = q.shape[0]
    if q.dim() != 4 or pos.shape != (B,) or n_valid.shape != (B,) \
            or block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("paged_chunk_attention kernel: q must be (B, C, H, "
                         "D), pos/n_valid (B,) and block_tables (B, Tb)")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _raise_on(lib, fn, err):
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed ({err}): {msg}")


def _launch(lib, fn, q, k_pages, k_scale, *args, tail=()):
    """Call a C entry point with the dtype codes, device, current stream
    and ``tail`` appended; raise on a non-zero return; count the launch."""
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(lib, fn, getattr(lib, fn)(
        *args, int(q.dtype == torch.bfloat16), _KV_TYPES[k_pages.dtype],
        q.device.index, stream, *tail))
    LAUNCHES[kernel_label(fn, k_pages, k_scale)] += 1


def _workspace(sizer, q, k_pages, block_tables):
    """The device workspace a kernel needs for these arguments, as
    ``sizer`` (a C entry over (q's leading dims: T or B, or B and C, then
    H, Hkv, D, page, Tb, q_bf16, kv_type)) gives its bytes; None when it
    needs none."""
    H, D = q.shape[-2:]
    _, page, Hkv, _ = k_pages.shape
    nbytes = sizer(*q.shape[:-2], H, Hkv, D, page, block_tables.shape[1],
                   int(q.dtype == torch.bfloat16), _KV_TYPES[k_pages.dtype])
    if nbytes == 0:
        return None
    return torch.empty(nbytes, dtype=torch.uint8, device=q.device)


def _packed_workspace(lib, q, k_pages, block_tables):
    """The device workspace the packed kernels need for these arguments
    (None when they need none: fp32 q or fp32 pages)."""
    return _workspace(lib.paged_packed_workspace_bytes, q, k_pages,
                      block_tables)


def paged_packed_attention_cuda(q, k_pages, v_pages, block_tables, tok_slot,
                                tok_pos, *, scale=None, k_scale=None,
                                v_scale=None):
    """Launch the packed kernel (or its scale variant) on PyTorch's current
    stream (no sync)."""
    check_kernel_args(q, k_pages, v_pages, block_tables, tok_slot, tok_pos,
                      k_scale, v_scale)
    T, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if T == 0:
        return out
    lib = _lib()
    ws = _packed_workspace(lib, q, k_pages, block_tables)
    _launch(lib, "paged_packed_attention", q, k_pages, k_scale,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            tok_slot.data_ptr(), tok_pos.data_ptr(), out.data_ptr(), T, H,
            Hkv, D, page, block_tables.shape[1], float(scale),
            tail=(_ptr(ws), 0 if ws is None else ws.numel()))
    return out


def paged_packed_plan_cuda(q, k_pages, block_tables, tok_slot, tok_pos):
    """Run the tensor-core packed kernel's plan kernel alone and read its
    work list back: int32 (n, 4) on the host, to hold against
    ``packed_work_list``.  A check, not a launch path: it synchronises.
    ``k_pages`` gives only the shapes: the plan reads no page and its list
    depends on no page type, so a bf16 pool stands for int8 / fp8 ones."""
    check_kernel_args(q, k_pages, k_pages, block_tables, tok_slot, tok_pos)
    T, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    lib = _lib()
    ws = _packed_workspace(lib, q, k_pages, block_tables)
    if ws is None:
        raise ValueError("paged_packed_plan: fp32 q or fp32 pages have no "
                         "work list")
    _raise_on(lib, "paged_packed_plan", lib.paged_packed_plan(
        tok_slot.data_ptr(), tok_pos.data_ptr(), T, H, Hkv, D, page,
        block_tables.shape[1], ws.data_ptr(), ws.numel(), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream))
    n = int(ws[:4].view(torch.int32).item())
    return ws[16:16 + 16 * n].view(torch.int32).reshape(n, 4).cpu()


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                                *, scale=None, k_scale=None, v_scale=None):
    """Launch the decode kernel (or its scale variant) on PyTorch's current
    stream (no sync)."""
    check_decode_args(q, k_pages, v_pages, block_tables, seq_lens, k_scale,
                      v_scale)
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    # the key-split route's partials (bf16 q on bf16, int8 or fp8 pages,
    # several splits)
    ws = _workspace(lib.paged_decode_workspace_bytes, q, k_pages,
                    block_tables)
    _launch(lib, "paged_decode_attention", q, k_pages, k_scale,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), B, H, Hkv, D, page,
            block_tables.shape[1], float(scale),
            tail=(_ptr(ws), 0 if ws is None else ws.numel()))
    return out


def paged_chunk_attention_cuda(q, k_pages, v_pages, block_tables, pos,
                               n_valid, *, scale=None, k_scale=None,
                               v_scale=None):
    """Launch the chunk kernel (or its scale variant) on PyTorch's current
    stream (no sync)."""
    check_chunk_args(q, k_pages, v_pages, block_tables, pos, n_valid,
                     k_scale, v_scale)
    B, C, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if B * C == 0:
        return out
    lib = _lib()
    # the tensor-core route's split partials (few row-tile items)
    ws = _workspace(lib.paged_chunk_workspace_bytes, q, k_pages,
                    block_tables)
    _launch(lib, "paged_chunk_attention", q, k_pages, k_scale,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            pos.data_ptr(), n_valid.data_ptr(), out.data_ptr(), B, C, H, Hkv,
            D, page, block_tables.shape[1], float(scale),
            tail=(_ptr(ws), 0 if ws is None else ws.numel()))
    return out


# --------------------------------------------------------------------------- #
# the page copy
# --------------------------------------------------------------------------- #
def check_page_pairs(num_pages, src, dst):
    """Host index lists of a page copy -> (src, dst) as lists of ints.
    Raise ValueError unless both have one entry per pair, every id is a
    page of the pool, the ``dst`` pages are distinct and none of them is
    also a ``src`` page (the kernel's blocks run in no order, so an overlap
    would race; the reference forbids it, ``ref.py:170-175``).  ``src`` may
    repeat."""
    src, dst = [int(i) for i in src], [int(i) for i in dst]
    if len(src) != len(dst):
        raise ValueError(f"page copy: {len(src)} src pages but {len(dst)} "
                         f"dst pages")
    if any(not 0 <= i < num_pages for i in src + dst):
        raise ValueError(f"page copy: page ids outside [0, {num_pages})")
    if len(set(dst)) != len(dst):
        raise ValueError("page copy: dst pages must be distinct")
    if set(dst) & set(src):
        raise ValueError("page copy: a dst page is also a src page")
    return src, dst


def copy_pages_plain(pool, src, dst, *, stacked=False):
    """``ref.copy_pages_ref`` in place: the rows of pages ``src`` written
    over pages ``dst``, as bytes (a snapshot of the ``src`` rows is taken
    first), in pool (P, page, ...) of any dtype or, ``stacked``, in every
    layer of pool (L, P, page, ...).  Returns the pool."""
    lead = tuple(pool.shape[:2]) if stacked else (1, pool.shape[0])
    rows = pool.view(*lead, -1).view(torch.uint8)
    idx = lambda v: torch.tensor(v, dtype=torch.long,        # noqa: E731
                                 device=pool.device)
    rows[:, idx(dst)] = rows[:, idx(src)]
    return pool


def _copy_lib():
    from repro_torch.kernels import build
    lib = build.load("page_copy")
    if lib.page_copy.argtypes is None:
        i, ptr = ctypes.c_int, ctypes.POINTER
        # bases, page_bytes, pages, layers; n_leaves; src, dst; n, device;
        # stream
        lib.page_copy.argtypes = [
            ptr(ctypes.c_ulonglong), ptr(ctypes.c_longlong), ptr(i), ptr(i),
            i, ptr(i), ptr(i), i, i, ctypes.c_void_p]
        lib.page_copy.restype = i
        lib.page_copy_error_string.argtypes = [i]
        lib.page_copy_error_string.restype = ctypes.c_char_p
    return lib


def leaf_pages(leaves):
    """Pages a layer of every leaf ((pool, stacked) pairs: pool (P, page,
    ...) or, stacked, (L, P, page, ...)); ValueError unless they agree (the
    page ids of a copy name a page of every layer of every leaf)."""
    pages = {pool.shape[1] if stacked else pool.shape[0]
             for pool, stacked in leaves}
    if len(pages) != 1:
        raise ValueError(f"page copy: the pools hold {sorted(pages)} pages "
                         f"a layer, not one count")
    return pages.pop()


def copy_leaf_table(leaves):
    """The kernel's leaf table of (pool, stacked) pairs: one (base address,
    bytes a page, pages a layer, layers) a leaf."""
    table = []
    for pool, stacked in leaves:
        layers, pages = pool.shape[:2] if stacked else (1, pool.shape[0])
        table.append((pool.data_ptr(), pool.numel() // (layers * pages)
                      * pool.element_size(), pages, layers))
    return table


def copy_launches(table, src, dst):
    """The page copy's launches: [(leaf table, src, dst)], the whole table
    in each, the pairs in runs of at most ``COPY_MAX_PAIRS``, in order."""
    return [(table, src[j:j + COPY_MAX_PAIRS], dst[j:j + COPY_MAX_PAIRS])
            for j in range(0, len(src), COPY_MAX_PAIRS)]


def page_copy_cuda(leaves, src, dst):
    """Launch the page-copy kernel on PyTorch's current stream (no sync)
    for CUDA pools ``leaves`` ((pool, stacked) pairs, one device,
    contiguous) and host page lists ``src`` / ``dst`` already checked by
    ``check_page_pairs``: one launch for up to ``COPY_MAX_PAIRS`` pairs
    (more than ``COPY_MAX_LEAVES`` leaves raise), nothing uploaded (the
    table and the ids go in the launch's parameters).  Returns the
    leaves."""
    dev = leaves[0][0].device
    _check_device("page_copy", {f"pool {k}": pool
                                for k, (pool, _) in enumerate(leaves)}, dev)
    lib = _copy_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    c = ctypes
    for table, s, d in copy_launches(copy_leaf_table(leaves), src, dst):
        k, n = len(table), len(s)
        base, nbytes, pages, layers = zip(*table)
        err = lib.page_copy(
            (c.c_ulonglong * k)(*base), (c.c_longlong * k)(*nbytes),
            (c.c_int * k)(*pages), (c.c_int * k)(*layers), k,
            (c.c_int * n)(*s), (c.c_int * n)(*d), n, dev.index, stream)
        if err != 0:
            msg = lib.page_copy_error_string(err).decode()
            raise RuntimeError(f"page_copy kernel launch failed ({err}): "
                               f"{msg}")
        LAUNCHES["page_copy"] += 1
    return leaves


# --------------------------------------------------------------------------- #
# the meta route
# --------------------------------------------------------------------------- #
def _attention_meta(label, q, k_pages, v_pages, block_tables, k_scale,
                    v_scale, more, ws_bytes):
    """The attention kernels' meta route: the output like q, the CUDA
    route's workspace (``ws_bytes``, when the split route runs), and 4 D
    flops a table key a query head for every row of q."""
    out = torch.empty_like(q)
    if ws_bytes and _split_route(q, k_pages):
        torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    H, D = q.shape[-2:]
    keys = block_tables.shape[1] * k_pages.shape[1]
    rows = q.numel() // (H * D)
    meta.add(kernel_label(label, k_pages, k_scale), 4 * D * keys * H * rows,
             (q, k_pages, v_pages, block_tables, k_scale, v_scale, *more),
             (out,))
    return out


def paged_packed_attention_meta(q, k_pages, v_pages, block_tables, tok_slot,
                                tok_pos, *, scale=None, k_scale=None,
                                v_scale=None):
    T, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    return _attention_meta(
        "paged_packed_attention", q, k_pages, v_pages, block_tables, k_scale,
        v_scale, (tok_slot, tok_pos),
        T and packed_workspace_size(T, H, Hkv, D, page,
                                    block_tables.shape[1]))


def paged_decode_attention_meta(q, k_pages, v_pages, block_tables, seq_lens,
                                *, scale=None, k_scale=None, v_scale=None):
    B, H, D = q.shape
    return _attention_meta(
        "paged_decode_attention", q, k_pages, v_pages, block_tables, k_scale,
        v_scale, (seq_lens,),
        B and decode_workspace_size(B, H, D, k_pages.shape[1],
                                    block_tables.shape[1]))


def paged_chunk_attention_meta(q, k_pages, v_pages, block_tables, pos,
                               n_valid, *, scale=None, k_scale=None,
                               v_scale=None):
    B, C, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    return _attention_meta(
        "paged_chunk_attention", q, k_pages, v_pages, block_tables, k_scale,
        v_scale, (pos, n_valid),
        B * C and chunk_workspace_size(B, C, H, Hkv, D, page,
                                       block_tables.shape[1]))


# --------------------------------------------------------------------------- #
# public entry points: plain version on the CPU, kernel on the card
# --------------------------------------------------------------------------- #
def paged_packed_attention(q, k_pages, v_pages, block_tables, tok_slot,
                           tok_pos, *, scale=None, k_scale=None,
                           v_scale=None):
    """Packed ragged paged attention: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (never the plain version there)."""
    fn = meta.route(q, paged_packed_attention_plain,
                    paged_packed_attention_meta, paged_packed_attention_cuda)
    return fn(q, k_pages, v_pages, block_tables, tok_slot, tok_pos,
              scale=scale, k_scale=k_scale, v_scale=v_scale)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           scale=None, k_scale=None, v_scale=None):
    """Paged decode attention: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (never the plain version there)."""
    fn = meta.route(q, paged_decode_attention_plain,
                    paged_decode_attention_meta, paged_decode_attention_cuda)
    return fn(q, k_pages, v_pages, block_tables, seq_lens, scale=scale,
              k_scale=k_scale, v_scale=v_scale)


def paged_chunk_attention(q, k_pages, v_pages, block_tables, pos, n_valid, *,
                          scale=None, k_scale=None, v_scale=None):
    """Chunked paged attention: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (never the plain version there)."""
    fn = meta.route(q, paged_chunk_attention_plain,
                    paged_chunk_attention_meta, paged_chunk_attention_cuda)
    return fn(q, k_pages, v_pages, block_tables, pos, n_valid, scale=scale,
              k_scale=k_scale, v_scale=v_scale)


def page_copy_leaves(leaves, src, dst):
    """Copy-on-write page copy in place over several pools at once:
    ``leaves`` (pool, stacked) pairs, pool (P, page, ...) or, stacked, (L,
    P, page, ...) of any dtype, every leaf with the same P; in every layer
    of every leaf the rows of pages ``src`` are written over pages ``dst``
    (host sequences of page ids; ``dst`` distinct and disjoint from
    ``src``, else ValueError, checked once for all leaves).  The plain
    version leaf by leaf for CPU pools, one kernel launch (or one per
    ``COPY_MAX_PAIRS`` pairs; at most ``COPY_MAX_LEAVES`` leaves) for CUDA
    pools, the meta route (bytes counted, nothing copied) for ``meta``
    pools.  Returns the leaves."""
    leaves = list(leaves)
    if not leaves:
        return leaves
    src, dst = check_page_pairs(leaf_pages(leaves), src, dst)
    devices = {pool.device for pool, _ in leaves}
    if len(devices) != 1:
        raise ValueError(f"page copy: pools on {sorted(map(str, devices))}")
    if leaves[0][0].device.type == "cpu":
        for pool, stacked in leaves:
            copy_pages_plain(pool, src, dst, stacked=stacked)
        return leaves
    if leaves[0][0].device.type == "meta":
        # the meta route: the pools stay as they are; the bytes of the
        # copied pages are counted, read once and written once
        for j in range(0, len(src), COPY_MAX_PAIRS):
            n = len(src[j:j + COPY_MAX_PAIRS])
            moved = [pool[:, :n] if stacked else pool[:n]
                     for pool, stacked in leaves]
            meta.add("page_copy", 0, moved, moved)
        return leaves
    return page_copy_cuda(leaves, src, dst) if src else leaves


def page_copy(pool, src, dst):
    """Copy-on-write page copy in place: pool (P, page, ...) of any dtype,
    ``src`` / ``dst`` host sequences of page ids (``dst`` distinct and
    disjoint from ``src``, else ValueError).  The plain version for a CPU
    pool, the CUDA kernel with a one-leaf table for a CUDA pool.  Returns
    the pool."""
    page_copy_leaves([(pool, False)], src, dst)
    return pool
