"""The Mamba2 block (SSD, state-space duality, arXiv:2405.21060) on torch
tensors.

Port of ``repro/models/ssm.py``: ``_dims`` (``:16``), ``mamba_init``
(``:24``), ``_split_in`` (``:43``), ``_causal_conv`` (``:50``, with and
without the streaming cache), ``_segsum`` (``:66``), ``ssd_chunked``
(``:74-135``), ``mamba_apply`` (``:138``), ``mamba_init_cache`` (``:160``)
and ``mamba_decode`` (``:168``).  The reference has no Pallas kernel here:
the intra-chunk products and the chunk states are PyTorch ops, as its are
``jnp``, and the inter-chunk ``lax.scan`` is a Python loop over the S /
chunk chunks that emits the state before each chunk.

Precision is the reference's: the decay and state math is fp32; the bulk
(head-dim) tensors keep the input dtype, and where the reference rounds an
operand to the input dtype and contracts it with
``preferred_element_type=float32`` the port rounds the same operand and
upcasts it to fp32 for the product (``torch.einsum`` on bf16 would return
bf16).  The scalars ``a_log``, ``dt_bias`` and ``D`` are read in fp32 and
stored in fp32 whatever the serving dtype (``SSM_FP32_LEAVES``): a bf16
``a_log`` would move A = -exp(a_log) by up to 0.4% and the recurrence
would compound it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

#: the mixer's 1-D leaves kept in fp32 in every dtype (read in fp32)
SSM_FP32_LEAVES = ("a_log", "dt_bias", "D")


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N  # x, B, C (n_groups = 1)
    return d_inner, H, N, conv_dim


def mamba_init(gen, cfg, dtype, device):
    """Random mixer weights at the reference's scales: ``in_proj`` (d, 2
    d_inner + 2 N + H) and ``out_proj`` (d_inner, d) in ``dtype``,
    ``conv_w`` (K, conv_dim) x 0.2 and ``conv_b`` zeros in ``dtype``; A's
    log ln(1..H), ``D`` ones and ``dt_bias`` = ln(expm1(0.01)) in fp32; the
    gated RMSNorm over d_inner."""
    d = cfg.d_model
    d_inner, H, N, conv_dim = _dims(cfg)
    in_dim = 2 * d_inner + 2 * N + H  # z, x, B, C, dt

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": normal((d, in_dim), 1.0 / np.sqrt(d)),
        "conv_w": normal((cfg.ssm_conv, conv_dim), 0.2),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.arange(1, H + 1, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), float(np.log(np.expm1(0.01))), **f32),
        "norm": L.norm_init(d_inner, "rmsnorm", device),
        "out_proj": normal((d_inner, d), 1.0 / np.sqrt(d_inner)),
    }


def _split_in(cfg, h):
    d_inner, H, N, _ = _dims(cfg)
    return torch.split(h, [d_inner, d_inner, N, N, H], dim=-1)


def _causal_conv(xBC, w, b, cache=None):
    """Depthwise causal convolution of window K = ``w.shape[0]`` over xBC
    (B, S, C), then SiLU.  ``cache`` (B, K-1, C): the previous inputs (the
    streamed decode), else zeros.  Returns (out (B, S, C), the last K - 1
    inputs (B, K-1, C), the next call's cache).  The K taps are summed in
    the reference's order."""
    K = w.shape[0]
    S = xBC.shape[1]
    if cache is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
    else:
        pad = cache.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    wd = w.to(xBC.dtype)
    out = xp[:, 0:S] * wd[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * wd[i]
    return F.silu(out + b.to(xBC.dtype)), xp[:, -(K - 1):]


def _segsum(a):
    """a (..., cs) -> (..., cs, cs) with T[i, j] = sum_{j < k <= i} a_k for
    j <= i, else -inf: differences of one cumsum, as the reference forms
    it (not the official Mamba code's masked cumsum)."""
    cs = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    T = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                 device=a.device))
    return T.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state=None):
    """SSD (the Mamba2 paper's listing), chunked.  x (b, s, h, p), dt (b, s,
    h) fp32 (after softplus), A (h,) negative fp32, Bm and Cm (b, s, n) ->
    (y (b, s, h, p) fp32, final state (b, h, p, n) fp32).  ``init_state``
    (b, h, p, n) carries a state in.  s must be a multiple of ``chunk``,
    as the reference asserts: nothing is padded."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise AssertionError(
            f"ssd_chunked: sequence length {s} is not a multiple of the "
            f"chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)

    # the decay / state math stays fp32; the head-dim tensors keep the
    # input dtype, rounded where the reference rounds them
    cdt = x.dtype
    xdt = xc * dtc[..., None].to(cdt)                  # input discretization
    Adt = (dtc * A[None, None, None, :]).to(f32)       # (b, nc, cs, h)
    Acum = torch.cumsum(Adt, dim=2)

    # intra-chunk: quadratic within a chunk
    Lmat = torch.exp(_segsum(Adt.permute(0, 1, 3, 2))).to(cdt)
    scores = torch.einsum("bzin,bzjn->bzij", Cc.to(f32),
                          Bc.to(f32)).to(cdt)
    y_diag = torch.einsum("bzhij,bzjhp->bzihp",
                          scores[:, :, None].to(f32) * Lmat.to(f32),
                          xdt.to(f32))

    # each chunk's final state
    decay_states = torch.exp(Acum[:, :, -1:, :] - Acum).to(cdt)
    states = torch.einsum("bzchp,bzcn->bzhpn",
                          decay_states[..., None].to(f32) * xdt.to(f32),
                          Bc.to(f32))

    # the inter-chunk recurrence, in fp32: emit the state before each chunk
    chunk_decay = torch.exp(Acum[:, :, -1, :])         # (b, nc, h)
    carry = (x.new_zeros((b, h, p, n), dtype=f32) if init_state is None
             else init_state.to(f32))
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)             # (b, nc, h, p, n)

    # the carried-in state's contribution
    state_decay = torch.exp(Acum)                      # (b, nc, cs, h)
    y_off = torch.einsum("bzcn,bzhpn->bzchp", Cc.to(f32), prev_states) \
        * state_decay[..., None]
    return (y_diag + y_off).reshape(b, s, h, p), carry


def _heads_out(p, cfg, x, xh, y, z):
    """D skip, the gated RMSNorm and ``out_proj``: y (.., H, P) fp32."""
    d_inner = _dims(cfg)[0]
    y = y + xh.to(torch.float32) * p["D"].float()[:, None]
    y = y.reshape(x.shape[:-1] + (d_inner,)).to(x.dtype)
    y = L.norm_apply(p["norm"], y * F.silu(z))
    return y @ p["out_proj"].to(x.dtype)


def mamba_apply(p, cfg, x, init_state=None, conv_cache=None):
    """The full-sequence Mamba2 mixer: x (B, S, d) -> (y (B, S, d), (final
    state (B, H, P, N) fp32, conv cache (B, K-1, conv_dim))).  The chunk is
    min(``cfg.ssm_chunk``, S)."""
    d_inner, H, N, _ = _dims(cfg)
    B, S, _ = x.shape
    h = x @ p["in_proj"].to(x.dtype)
    z, xc, Bm, Cm, dt = _split_in(cfg, h)
    xBC, new_conv = _causal_conv(torch.cat([xc, Bm, Cm], -1), p["conv_w"],
                                 p["conv_b"], conv_cache)
    xc, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    xh = xc.reshape(B, S, H, cfg.ssm_head_dim)
    y, state = ssd_chunked(xh, dt, A, Bm, Cm, min(cfg.ssm_chunk, S),
                           init_state)
    return _heads_out(p, cfg, x, xh, y, z), (state, new_conv)


def mamba_init_cache(cfg, batch, dtype, device):
    """One layer's decode cache: the SSM ``state`` (B, H, P, N) in fp32 and
    the ``conv`` window (B, K-1, conv_dim) in ``dtype``, zeros."""
    d_inner, H, N, conv_dim = _dims(cfg)
    return {
        "state": torch.zeros((batch, H, cfg.ssm_head_dim, N),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def mamba_decode(p, cfg, x, cache):
    """One token's state update: x (B, 1, d), cache {"state", "conv"} ->
    (y (B, 1, d), the new {"state", "conv"}).  The caller writes the new
    cache where it wants it (the reference returns it)."""
    d_inner, H, N, _ = _dims(cfg)
    B = x.shape[0]
    f32 = torch.float32
    h = x @ p["in_proj"].to(x.dtype)
    z, xc, Bm, Cm, dt = _split_in(cfg, h)
    xBC, new_conv = _causal_conv(torch.cat([xc, Bm, Cm], -1), p["conv_w"],
                                 p["conv_b"], cache["conv"])
    xc, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())[:, 0]       # (B, H)
    A = -torch.exp(p["a_log"].float())
    xh = xc[:, 0].reshape(B, H, cfg.ssm_head_dim).to(f32)
    dA = torch.exp(dt * A[None, :])                                # (B, H)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bm[:, 0].to(f32), xh)
    state = cache["state"] * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(f32), state)
    y = _heads_out(p, cfg, x, xh[:, None], y[:, None], z)
    return y, {"state": state, "conv": new_conv}
