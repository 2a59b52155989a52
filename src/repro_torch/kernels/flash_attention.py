"""Causal GQA flash attention for training: the CUDA kernels' wrappers, the
plain PyTorch versions and the ``torch.autograd.Function`` that joins them.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:76``
``flash_attention`` (body ``_flash_kernel``, ``:24``): q (B, Sq, H, D), k and
v (B, Sk, Hkv, D), D in ``HEAD_DIMS`` -> o (B, Sq, H, D) in q's dtype,
online softmax with fp32 accumulation, query head h reading KV head
h // (H // Hkv).  The JAX package has no backward kernel (its gradient is
XLA's autodiff of the plain code); the port's gradient is a hand-written
kernel too.

The kernels are ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``): the
forward writes O and the row log-sum-exp (B, H, Sq) fp32; the backward runs
delta = rowsum(dO * O), a dK/dV kernel per (key block, KV head) and a dQ
kernel per (query block, head), with no atomics, so two runs give the same
bits.  The dtype picks the kernels: bf16 runs on the tensor cores (``wgmma``
on TMA-fed, swizzled shared-memory tiles, one producer warp and two
consumer warpgroups per block, P and dS rounded to bf16 in registers as
the A operands of the second products; helpers in ``csrc/sm90_common.cuh``),
fp32 on the CUDA cores (fp32 products, which the fp32 train-step check
against the CPU needs).  What bounds them on an H100: operations, 4 D flops
per visible (query, key) pair per head at 989 TFLOP/s (the backward 2.5x);
the backward kernels form S and dP twice, 7 products where the bound
counts 5, to stay deterministic without atomics.

Causal alignment is at the start (key j is visible to query row i when
``j <= q_offset + i``), as the Pallas kernel and ``blockwise_attention``
align it; ``ref.attention_ref`` aligns at the end, and agrees only when
Sq == Sk.

gemma2's two options, which the TPU kernel does not take (the reference
runs them in ``blockwise_attention``, ``attention.py:21-66``): a sliding
``window`` (> 0: key j is also visible to row i only when
``j > q_offset + i - window``; 0 disables) and a logit softcap ``cap``
(!= 0: the scaled score s becomes ``tanh(s / cap) * cap`` before the mask
and the softmax; 0 disables).  The kernels load no key tile wholly below a
row block's window and mask only the edge tiles; the backward scales dS by
``1 - (s_c / cap)^2`` (tanh's derivative at the capped score s_c) before
the dQ and dK products.

The plain versions: the forward is ``models.attention.blockwise_attention``
(the reference's ``attention.py:21``: ``p`` rounded to v's dtype before the
P.V product) beside the row log-sum-exp; the backward applies the kernel's
formulas (P = exp(s - lse), dS = P * (dP - delta)) in fp32 torch ops.  They
run for CPU tensors; on a CUDA tensor the wrappers launch the kernels or
raise; on a ``meta`` tensor they take the meta route (``kernels/meta.py``:
the CUDA route's outputs and ``lse`` / ``delta``, its flops counted, nothing
computed).  ``LAUNCHES`` counts the wrappers' launches: ``flash_attention`` one
per forward call, ``flash_attention.bwd`` one per backward call (its three
kernels go down from one C entry point).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import meta

#: kernel launches since the last ``reset_launches()``, by kernel label
LAUNCHES = {}
HEAD_DIMS = (32, 64, 128, 192)
DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30


def reset_launches():
    LAUNCHES["flash_attention"] = 0
    LAUNCHES["flash_attention.bwd"] = 0


reset_launches()


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def _scores(q, k, scale, causal, q_offset, i0, window=0, cap=0.0):
    """fp32 scores (B, Hkv, G, bq, Sk) of the query rows ``i0 .. i0 + bq``
    (q holds just those rows): scaled, softcapped when ``cap``, masked
    (causal, and to ``window`` keys when window > 0) at -1e30."""
    B, bq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, bq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if cap:
        s = torch.tanh(s / cap) * cap
    if causal or window > 0:
        q_pos = q_offset + i0 + torch.arange(bq, device=q.device)[:, None]
        k_pos = torch.arange(Sk, device=q.device)[None]
        mask = torch.ones((bq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window > 0:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    return s


def flash_attention_plain(q, k, v, *, causal=True, window=0, cap=0.0,
                          scale=None, q_offset=0, block_q=512):
    """(o, lse): ``blockwise_attention``'s output and the fp32 row
    log-sum-exp (B, H, Sq) of the scaled, softcapped, masked scores."""
    from repro_torch.models.attention import blockwise_attention
    B, Sq, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    o = blockwise_attention(q, k, v, causal=causal, window=window, cap=cap,
                            scale=scale, q_offset=q_offset, block_q=block_q)
    lse = []
    for i0 in range(0, Sq, block_q):
        s = _scores(q[:, i0:i0 + block_q], k, scale, causal, q_offset, i0,
                    window, cap)
        lse.append(torch.logsumexp(s, dim=-1))          # (B, Hkv, G, bq)
    lse = torch.cat(lse, dim=-1).reshape(B, H, Sq)
    return o, lse


def flash_attention_bwd_plain(q, k, v, o, lse, dout, *, causal=True,
                              window=0, cap=0.0, scale=None, q_offset=0,
                              block_q=512):
    """The backward's formulas in fp32 torch ops, query block by query
    block: P = exp(s_c - lse), delta = rowsum(dO * O), dS = P * (dP -
    delta), times ``1 - (s_c / cap)^2`` under a softcap; dQ = scale * dS K,
    dK = scale * dS^T Q, dV = P^T dO (summed over the G query heads of each
    KV head; v, dout and o may be Dv < D wide).  Returns (dq, dk, dv) in
    the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G, Dv = H // Hkv, v.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    lse = lse.reshape(B, Hkv, G, Sq)
    for i0 in range(0, Sq, block_q):
        sl = slice(i0, i0 + block_q)
        bq = q[:, sl].shape[1]
        s = _scores(q[:, sl], k, scale, causal, q_offset, i0, window, cap)
        p = torch.exp(s - lse[..., sl, None])            # (B, Hkv, G, bq, Sk)
        do = dout[:, sl].float().reshape(B, bq, Hkv, G, Dv)
        delta = (do * o[:, sl].float().reshape(B, bq, Hkv, G, Dv)).sum(-1)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
        ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
        if cap:
            # tanh's derivative at the capped score; masked entries (p = 0)
            # are clamped to -cap so that the factor stays finite there
            ds = ds * (1 - (s.clamp(min=-abs(cap)) / cap).square())
        qg = q[:, sl].float().reshape(B, bq, Hkv, G, D)
        dq[:, sl] = (torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
                     * scale).reshape(B, bq, H, D)
        dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
        dv += torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------- #
# the CUDA kernels
# --------------------------------------------------------------------------- #
def _lib():
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, o, lse; B, Sq, Sk, H, Hkv, D; scale; causal, q_offset,
        # window; cap; is_bf16, device; stream
        lib.flash_attention_fwd.argtypes = [vp] * 5 + [i] * 6 + [f] + \
            [i] * 3 + [f] + [i] * 2 + [vp]
        lib.flash_attention_fwd.restype = i
        # q, k, v, o, lse, dout, dq, dk, dv, delta; B, Sq, Sk, H, Hkv, D;
        # scale; causal, q_offset, window; cap; is_bf16, device; stream
        lib.flash_attention_bwd.argtypes = [vp] * 10 + [i] * 6 + [f] + \
            [i] * 3 + [f] + [i] * 2 + [vp]
        lib.flash_attention_bwd.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_kernel_args(q, k, v, q_offset=0, window=0, cap=0.0, **more):
    """Raise on anything the kernels do not take: contiguous CUDA tensors
    on one device in one dtype (fp32 or bf16), q (B, Sq, H, D), k and v
    (B, Sk, Hkv, D) with Hkv dividing H, D in ``HEAD_DIMS``, q_offset >= 0,
    an int window (<= 0: none) and cap >= 0 (0: none); ``more`` (o, dout)
    like q."""
    named = {"q": q, "k": k, "v": v, **more}
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel takes CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"contiguous on {q.device} in {q.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} not in "
                         f"{DTYPES}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention kernel: q (B, Sq, H, D) and k, v "
                         f"(B, Sk, Hkv, D) with Hkv | H; got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {q.shape[3]} not "
                         f"in {HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError("flash_attention kernel: q_offset must be >= 0")
    if int(window) != window or not cap >= 0:
        raise ValueError(f"flash_attention kernel: window must be an int "
                         f"and cap >= 0; got {window!r}, {cap!r}")
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"{tuple(q.shape)}")


def _raise(lib, fn, err):
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed ({err}): {msg}")


def flash_attention_fwd_cuda(q, k, v, *, causal=True, window=0, cap=0.0,
                             scale=None, q_offset=0):
    """Launch the forward on PyTorch's current stream (no sync) ->
    (o, lse)."""
    check_kernel_args(q, k, v, q_offset, window, cap)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise(lib, "flash_attention", lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, H, Hkv, D, float(scale), int(causal),
        int(q_offset), int(window), float(cap),
        int(q.dtype == torch.bfloat16), q.device.index, stream))
    LAUNCHES["flash_attention"] += 1
    return o, lse


def flash_attention_bwd_cuda(q, k, v, o, lse, dout, *, causal=True,
                             window=0, cap=0.0, scale=None, q_offset=0):
    """Launch the backward on PyTorch's current stream (no sync) ->
    (dq, dk, dv)."""
    check_kernel_args(q, k, v, q_offset, window, cap, o=o, dout=dout)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention kernel: lse must be (B, H, Sq) "
                         "fp32, contiguous, on q's device")
    scale = D ** -0.5 if scale is None else scale
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise(lib, "flash_attention.bwd", lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, Sq, Sk, H, Hkv, D, float(scale),
        int(causal), int(q_offset), int(window), float(cap),
        int(q.dtype == torch.bfloat16), q.device.index, stream))
    LAUNCHES["flash_attention.bwd"] += 1
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# the meta route
# --------------------------------------------------------------------------- #
def visible_pairs(Sq, Sk, *, causal=True, window=0, q_offset=0) -> int:
    """(query row, key) pairs a head sees: key j visible to row i when j <=
    q_offset + i (causal) and j > q_offset + i - window (window > 0)."""
    i = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(Sk - 1, i) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def forward_flops(q, k, *, causal=True, window=0, q_offset=0) -> int:
    """The forward kernel's operations: 4 D a visible pair a head (QK^T and
    PV, D the kernel's head dim)."""
    B, Sq, H, D = q.shape
    return 4 * D * B * H * visible_pairs(Sq, k.shape[1], causal=causal,
                                         window=window, q_offset=q_offset)


def flash_attention_fwd_meta(q, k, v, *, causal=True, window=0, cap=0.0,
                             scale=None, q_offset=0):
    """The forward's meta route -> (o, lse) as the CUDA route allocates
    them."""
    B, Sq, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    meta.add("flash_attention", forward_flops(
        q, k, causal=causal, window=window, q_offset=q_offset),
        (q, k, v), (o, lse))
    return o, lse


def flash_attention_bwd_meta(q, k, v, o, lse, dout, *, causal=True,
                             window=0, cap=0.0, scale=None, q_offset=0):
    """The backward's meta route -> (dq, dk, dv), with the CUDA route's
    ``delta`` workspace; 2.5x the forward's flops."""
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    flops = 2.5 * forward_flops(q, k, causal=causal, window=window,
                                q_offset=q_offset)
    meta.add("flash_attention.bwd", flops, (q, k, v, o, lse, dout),
             (dq, dk, dv, delta))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v); the kernels for CUDA tensors, the plain
    versions for CPU tensors, the meta route for ``meta`` tensors.  Saves
    q, k, v, o and lse for the backward; under activation checkpointing
    the forward runs again and, being the same kernel on the same inputs,
    gives the same bits."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, block_q, window, cap):
        args = dict(causal=causal, window=window, cap=cap, scale=scale,
                    q_offset=q_offset)
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, block_q=block_q, **args)
        elif q.device.type == "meta":
            o, lse = flash_attention_fwd_meta(q, k, v, **args)
        else:
            o, lse = flash_attention_fwd_cuda(q, k, v, **args)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = args
        ctx.block_q = block_q
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, o, lse, dout, block_q=ctx.block_q, **ctx.args)
        else:
            bwd = flash_attention_bwd_meta if q.device.type == "meta" \
                else flash_attention_bwd_cuda
            dq, dk, dv = bwd(q, k, v, o, lse, dout.contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0, scale=None,
                    q_offset=0, block_q=512):
    """Differentiable causal GQA attention: q (B, Sq, H, D), k (B, Sk, Hkv,
    D) and v (B, Sk, Hkv, Dv) with Dv <= D -> (B, Sq, H, Dv), with an
    optional sliding ``window`` and logit softcap ``cap``.  The kernels for
    CUDA tensors (made contiguous first), the plain versions for CPU
    tensors, the meta route (the CUDA route's layout) for ``meta``
    tensors.

    The kernels take one head dim: for a narrower v (MLA: qk 192, v 128)
    the CUDA route pads v with zeros to D and returns the first Dv columns
    of o.  That is exact: the padded columns of O, and so of dO and dV,
    are zero, P and dP never read them, and delta = rowsum(dO * O) gains
    only zeros.  The CPU route runs the plain versions at Dv."""
    Dv = v.shape[-1]
    if Dv > q.shape[-1]:
        raise ValueError(f"flash_attention: v is {Dv} wide, wider than "
                         f"q / k ({q.shape[-1]})")
    if q.device.type != "cpu":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if Dv < q.shape[-1]:
            v = torch.nn.functional.pad(v, (0, q.shape[-1] - Dv))
            return FlashAttention.apply(q, k, v, causal, scale, q_offset,
                                        block_q, int(window),
                                        float(cap))[..., :Dv]
    return FlashAttention.apply(q, k, v, causal, scale, q_offset, block_q,
                                int(window), float(cap))
