"""FAL's MLP-input fusion ``y = LN(x) * scale (+ bias) + a1n``: the CUDA
kernels' wrappers, the plain PyTorch version and the
``torch.autograd.Function`` that joins them.

Replaces the Pallas TPU kernel ``repro/kernels/fused_ln_add.py:37``
``fused_ln_add`` (body ``_ln_add_kernel``, ``:24``): rmsnorm or layernorm
(eps 1e-6) of x in fp32, times the fp32 scale (plus the bias), plus a1n,
rounded once to x's dtype.  The JAX package has no backward kernel; the
port's backward is a kernel too.

The kernels are ``csrc/fused_ln_add.cu`` (CUDA C++ for ``sm_90a``): the
forward, a fixed group of warps a row (the row's vectors held in
registers from the statistic to the output, so it is read once; the
warps' sums added in a fixed order, so a row's bits do not depend on the
row count; several rows a block where rows are many), writes y and, when
a backward will read them (``stats``), each row's rstd and mean; the
backward, a grid of two blocks an SM taking rows in a fixed order with
a row's x and dy held in registers, writes dx per row and one fp32 partial
row of dscale (and dbias) a block, which a second launch sums column by
column in a fixed two-level order, with no atomics
(``tests/test_torch_fused_ln_add.py`` emulates that order).  d(a1n) is
dy.  What bounds them on an H100: bytes (see the source's header).

The plain version is ``ref.ln_add_ref`` (``repro/kernels/ref.py:178``) in
torch ops; its gradient is autograd through it.  In fp32 it gives the bits
of the reference's ``norm_apply(p, x) + a1n`` (``core/fal.py``), so the
port's fp32 outputs do not move.  In bf16 the fused result rounds
``LN(x) + a1n`` once, where ``norm_apply(p, x) + a1n`` rounds LN(x) and then
the sum: the two differ by at most one bf16 ulp of the larger of |LN(x)| and
|LN(x) + a1n| (``tests/test_torch_fused_ln_add.py``).

The plain version runs for CPU tensors; on a CUDA tensor the wrappers
launch the kernels or raise.  ``fused_ln_add`` goes through the autograd
Function (statistics saved) only when a gradient can flow: grad mode on
and an input that requires grad; otherwise (serving) it launches the
forward alone, with no statistics, and y has the same bits.
``LAUNCHES`` counts the wrappers' launches:
``fused_ln_add`` one per forward call, ``fused_ln_add.bwd`` one per backward
call (its two or three kernels go down from one C entry point).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models import layers as L

#: kernel launches since the last ``reset_launches()``, by kernel label
LAUNCHES = {}
KINDS = ("rmsnorm", "layernorm")
DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 8192


def reset_launches():
    LAUNCHES["fused_ln_add"] = 0
    LAUNCHES["fused_ln_add.bwd"] = 0


reset_launches()


def ln_add_plain(x, a1n, scale, bias=None, *, kind="rmsnorm", eps=1e-6):
    """``ref.ln_add_ref`` in torch ops: ``layers.norm_apply`` of x in fp32
    (the same formula) plus a1n, cast to x's dtype once."""
    p = {"scale": scale} if bias is None else {"scale": scale, "bias": bias}
    y = L.norm_apply(p, x.float(), kind, eps)
    return (y + a1n.float()).to(x.dtype)


def _lib():
    from repro_torch.kernels import build
    lib = build.load("fused_ln_add")
    if lib.fused_ln_add_fwd.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # x, a1, scale, bias, y, mean, rstd; rows, d, kind; eps; is_bf16,
        # device; stream
        lib.fused_ln_add_fwd.argtypes = [vp] * 7 + [i] * 3 + [f] + [i] * 2 \
            + [vp]
        lib.fused_ln_add_fwd.restype = i
        # dy, x, scale, mean, rstd, dx, dscale, dbias, part; rows, d, kind,
        # is_bf16, device; stream
        lib.fused_ln_add_bwd.argtypes = [vp] * 9 + [i] * 5 + [vp]
        lib.fused_ln_add_bwd.restype = i
        lib.fused_ln_add_bwd_blocks.argtypes = [i, i]
        lib.fused_ln_add_bwd_blocks.restype = i
        lib.fused_ln_add_error_string.argtypes = [i]
        lib.fused_ln_add_error_string.restype = ctypes.c_char_p
    return lib


def check_kernel_args(x, scale, kind, *, bias=None, forward=True, **rows):
    """Raise on anything the kernels do not take: x and ``rows`` (a1n, dy)
    contiguous CUDA tensors of one shape (..., d) and dtype (fp32 or bf16),
    d <= 8192; scale (and, for a layernorm forward, bias) (d,) fp32
    contiguous on the same device."""
    if kind not in KINDS:
        raise ValueError(f"fused_ln_add kernel: kind {kind!r} not in {KINDS}")
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_add kernel takes CUDA tensors; x is on "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"fused_ln_add kernel: dtype {x.dtype} not in "
                         f"{DTYPES}")
    d = x.shape[-1]
    if not 0 < d <= MAX_D:
        raise ValueError(f"fused_ln_add kernel: d = {d} not in 1..{MAX_D}")
    for name, t in {"x": x, **rows}.items():
        if t.device != x.device or t.dtype != x.dtype \
                or not t.is_contiguous() or t.shape != x.shape:
            raise ValueError(f"fused_ln_add kernel: {name} must be "
                             f"contiguous {tuple(x.shape)} on {x.device} in "
                             f"{x.dtype}")
    params = {"scale": scale}
    if kind == "layernorm" and forward:
        params["bias"] = bias
    for name, t in params.items():
        if t is None or t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != (d,):
            raise ValueError(f"fused_ln_add kernel: {name} must be ({d},) "
                             f"fp32, contiguous, on {x.device}")


def _raise(lib, fn, err):
    if err != 0:
        msg = lib.fused_ln_add_error_string(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed ({err}): {msg}")


def fused_ln_add_fwd_cuda(x, a1n, scale, bias=None, *, kind="rmsnorm",
                          eps=1e-6, stats=True):
    """Launch the forward on PyTorch's current stream (no sync) ->
    (y, mean, rstd); mean and rstd are (rows,) fp32 (mean 0 for rmsnorm),
    or None, None without ``stats`` (nothing allocated or written for
    them; y is the same)."""
    check_kernel_args(x, scale, kind, bias=bias, a1n=a1n)
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty(rows, dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise(lib, "fused_ln_add", lib.fused_ln_add_fwd(
        x.data_ptr(), a1n.data_ptr(), scale.data_ptr(),
        bias.data_ptr() if kind == "layernorm" else None, y.data_ptr(),
        mean.data_ptr() if stats else None,
        rstd.data_ptr() if stats else None, rows, d, KINDS.index(kind),
        float(eps), int(x.dtype == torch.bfloat16), x.device.index, stream))
    LAUNCHES["fused_ln_add"] += 1
    return y, mean, rstd


def fused_ln_add_bwd_cuda(dy, x, scale, mean, rstd, *, kind="rmsnorm"):
    """Launch the backward on PyTorch's current stream (no sync) ->
    (dx, dscale, dbias); dbias is None for rmsnorm."""
    check_kernel_args(x, scale, kind, forward=False, dy=dy)
    d = x.shape[-1]
    rows = x.numel() // d
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (rows,) or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"fused_ln_add kernel: {name} must be "
                             f"({rows},) fp32 on {x.device}")
    lib = _lib()
    n_parts = lib.fused_ln_add_bwd_blocks(rows, x.device.index)
    if n_parts < 0:
        raise RuntimeError(f"fused_ln_add.bwd: cannot query {x.device}")
    ln = kind == "layernorm"
    dx = torch.empty_like(x)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dscale) if ln else None
    part = torch.empty(((2 if ln else 1) * max(n_parts, 1), d),
                       dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise(lib, "fused_ln_add.bwd", lib.fused_ln_add_bwd(
        dy.data_ptr(), x.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        dbias.data_ptr() if ln else None, part.data_ptr(), rows, d,
        KINDS.index(kind), int(x.dtype == torch.bfloat16), x.device.index,
        stream))
    LAUNCHES["fused_ln_add.bwd"] += 1
    return dx, dscale, dbias


class FusedLnAdd(torch.autograd.Function):
    """y = LN(x) * scale (+ bias) + a1n on CUDA tensors through the kernels,
    forward and backward; a1n is in x's dtype.  Saves x, scale and the
    per-row statistics; d(a1n) = dy."""

    @staticmethod
    def forward(ctx, x, a1n, scale, bias, kind, eps):
        y, mean, rstd = fused_ln_add_fwd_cuda(x, a1n, scale, bias, kind=kind,
                                              eps=eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.kind = kind
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        dy = dy.contiguous()
        dx, dscale, dbias = fused_ln_add_bwd_cuda(dy, x, scale, mean, rstd,
                                                  kind=ctx.kind)
        return dx, dy, dscale, dbias, None, None


def fused_ln_add(x, a1n, scale, bias=None, *, kind="rmsnorm", eps=1e-6):
    """Differentiable ``LN(x) * scale (+ bias) + a1n``, x and a1n (..., d)
    -> (..., d) in x's dtype: the plain version for CPU tensors, the
    kernels for CUDA tensors (a1n cast to x's dtype first, and the
    gradient cast back by autograd; with no gradient to take, the forward
    kernel alone, without the statistics)."""
    if x.device.type == "cpu":
        return ln_add_plain(x, a1n, scale, bias, kind=kind, eps=eps)
    a1n = a1n.to(x.dtype).contiguous()
    x = x.contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, a1n, scale, bias)):
        return FusedLnAdd.apply(x, a1n, scale, bias, kind, eps)
    return fused_ln_add_fwd_cuda(x, a1n, scale, bias, kind=kind, eps=eps,
                                 stats=False)[0]
