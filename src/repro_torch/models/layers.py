"""Shared primitive layers on torch tensors: norms, RoPE, MLPs,
embeddings, softcap, and their random initialisers.

Port of ``repro/models/layers.py``.  Weights keep the JAX ``(d_in, d_out)``
layout, so ``x @ w`` maps one to one.  Matmul weights and embeddings are
held in the activation dtype (the reference casts them per use); norm
scales and biases stay fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- norms ----
def norm_init(d, kind="rmsnorm", device="cpu"):
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_apply(p, x, kind="rmsnorm", eps=1e-6):
    """RMSNorm or LayerNorm computed in fp32, cast back to x's dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        y = y * p["scale"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------------ rope ----
#: (head_dim, theta, device) -> inverse frequencies, so a tick on the card
#: does not copy them from the host in every layer
_FREQS = {}


def rope_freqs(head_dim, theta=10000.0, device="cpu"):
    key = (head_dim, float(theta), torch.device(device))
    inv = _FREQS.get(key)
    if inv is None:
        half = head_dim // 2
        f = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
        inv = torch.from_numpy(np.asarray(f, np.float32)).to(device)
        _FREQS[key] = inv
    return inv


def apply_rope(x, positions, theta=10000.0):
    """Split-half RoPE.  x: (..., S, H, D); positions broadcastable to
    (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., :, None].float() * inv           # (..., S, half)
    ang = ang[..., None, :]                               # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- softcap ----
def softcap(x, cap):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------- linear ----
def dense_init(gen, d_in, d_out, dtype, device, scale=None):
    """(d_in, d_out) normal weights * scale (default 1/sqrt(d_in))."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


def dense_apply(w, x):
    return x @ w.to(x.dtype)


# ------------------------------------------------------------------- mlp ----
def mlp_init(gen, d, d_ff, kind, dtype, device):
    p = {"wi": dense_init(gen, d, d_ff, dtype, device)}
    if kind in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, d, d_ff, dtype, device)
    p["wo"] = dense_init(gen, d_ff, d, dtype, device,
                         scale=1.0 / np.sqrt(d_ff))
    return p


def mlp_apply(p, x, kind="swiglu"):
    """swiglu / geglu gate on ``wg``; JAX's ``gelu`` is the tanh form."""
    w_i = p["wi"].to(x.dtype)
    if kind == "swiglu":
        h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ w_i)
    elif kind == "geglu":
        h = F.gelu(x @ p["wg"].to(x.dtype), approximate="tanh") * (x @ w_i)
    else:
        h = F.gelu(x @ w_i, approximate="tanh")
    return h @ p["wo"].to(x.dtype)


# -------------------------------------------------------------- embedding ----
def embed_init(gen, vocab, d, dtype, device):
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32) * 0.02
    return {"emb": w.to(dtype)}


def embed_apply(p, tokens, dtype):
    return p["emb"].to(dtype)[tokens.long()]


def unembed_apply(p, x, final_cap=0.0):
    logits = x @ p["emb"].to(x.dtype).T
    return softcap(logits, final_cap)
