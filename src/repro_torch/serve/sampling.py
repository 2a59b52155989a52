"""Token sampling for the port's serving engine: greedy / temperature /
top-k / top-p, seeded per request, batched over lanes.

Port of ``repro/serve/sampling.py``: ``SamplingParams``, ``_mask_top_k``
(``:40``), ``_mask_top_p`` (``:56``), ``sample_tokens`` (``_sample_one``
``:77`` under ``vmap``, here a batch dimension written out),
``TOPK_FAST_CAP`` (``:103``), ``fast_eligible`` (``:106``) and
``fast_sampler`` (``:114``).  Keys are ``fold_in(PRNGKey(seed), position)``
(``serve/prng.py``, threefry bit for bit as ``jax.random``), so a preempted
request that re-prefills and resumes at the same positions draws the same
tokens.  Everything runs on the logits' device; nothing here is a kernel of
the reference (its sampler is ``jnp`` inside the jitted tick).

Where the reference's order is observable, the port reproduces it:

* ties: ``jnp.argsort`` is stable and ``lax.top_k`` puts the lower index
  first.  The port sorts and selects on a 64-bit key per token: the fp32
  value's order-preserving bits (the total order of JAX's float sort, -0.0
  below +0.0) in the high word and ``V - 1 - index`` in the low word.  The
  keys are distinct, so ``torch.sort`` / ``torch.topk`` on them give the
  reference's order on any device;
* the prefix mass of ``_mask_top_p``: ``cumsum`` follows the order of
  XLA's CPU rewrite of ``jnp.cumsum`` (rows of 16 scanned in order, the
  row totals scanned the same way, recursively), as adds only, so it is the
  same sum on the CPU and on the card.

What is not reproduced: ``exp`` and ``log`` are torch's, which differ from
XLA's CPU ones in the last bit for about one value in ten, and the softmax
total is summed in torch's order.  The Gumbel noise therefore agrees with
the reference within a few ulps, and a top-p boundary whose exclusive mass
lies within rounding of ``p`` can keep or drop its token differently.  The
sampled tokens agree unless such a token wins the draw or two candidates tie
within those ulps (``tests/test_torch_sampling.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.serve import prng


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0          # 0 -> greedy (argmax)
    top_k: int = 0                    # 0 -> disabled
    top_p: float = 1.0                # >= 1 -> disabled
    seed: int = 0

    @staticmethod
    def greedy() -> "SamplingParams":
        return SamplingParams()


def greedy(logits):
    """logits (..., V) -> int32 ids of the first maximum, computed in fp32
    (``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def greedy_sampler(logits, temps, top_ks, top_ps, seeds, positions):
    """``sample_tokens`` for a batch whose lanes all have temperature <= 0:
    their token is the argmax whatever the other parameters, so no mask and
    no noise is computed."""
    return greedy(logits)


# --------------------------------------------------------------------------- #
# the reference's orders
# --------------------------------------------------------------------------- #
def order_keys(x):
    """(..., V) fp32 -> (..., V) int64 keys, distinct, whose descending order
    is the stable descending order of ``x`` (ties: lower index first)."""
    bits = x.float().contiguous().view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    V = x.shape[-1]
    low = (V - 1) - torch.arange(V, dtype=torch.int64, device=x.device)
    return (ordered << 32) | low


def sort_desc(x):
    """Indices of ``jnp.argsort(-x)`` (stable) along the last axis."""
    return torch.sort(order_keys(x), dim=-1, descending=True).indices


#: row length of XLA's CPU rewrite of a cumulative sum
_SCAN_ROW = 16


def _scan_rows(x):
    out = x.clone()
    out[..., 0] = 0.0 + x[..., 0]
    for i in range(1, x.shape[-1]):
        out[..., i] = out[..., i - 1] + x[..., i]
    return out


def cumsum(x):
    """``jnp.cumsum(x, -1)`` in the order XLA's CPU backend adds: up to 16
    values in order; longer rows padded to rows of 16, each scanned in order,
    plus the scan of the row totals before it (computed the same way)."""
    n = x.shape[-1]
    if n <= _SCAN_ROW:
        return _scan_rows(x)
    m = -(-n // _SCAN_ROW)
    w = _scan_rows(F.pad(x, (0, m * _SCAN_ROW - n))
                   .reshape(x.shape[:-1] + (m, _SCAN_ROW)))
    carry = F.pad(cumsum(w[..., -1])[..., :-1], (1, 0))
    return (w + carry[..., None]).reshape(
        x.shape[:-1] + (m * _SCAN_ROW,))[..., :n]


def softmax(x):
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


# --------------------------------------------------------------------------- #
# the reference sampler
# --------------------------------------------------------------------------- #
def mask_top_k(logits, k):
    """``_mask_top_k`` for each lane: keep exactly the ``k`` (B,) highest
    logits of (B, V) (k <= 0 keeps all), ties toward the lower index."""
    V = logits.shape[-1]
    kk = torch.where(k <= 0, V, k.clamp(1, V))
    rank = torch.empty_like(logits, dtype=torch.int64)
    rank.scatter_(-1, sort_desc(logits),
                  torch.arange(V, device=logits.device).expand_as(rank))
    return torch.where(rank < kk[:, None], logits, -torch.inf)


def mask_top_p(logits, p):
    """``_mask_top_p`` for each lane: keep the smallest prefix of the stable
    descending sort whose mass reaches ``p`` (B,) (p >= 1 keeps all; the top
    token always survives)."""
    probs = softmax(logits)
    order = sort_desc(probs)
    sp = torch.gather(probs, -1, order)
    keep_sorted = (cumsum(sp) - sp) < p[:, None]
    keep_sorted[:, 0] = True
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep | (p >= 1.0)[:, None], logits, -torch.inf)


def gumbel(seeds, positions, V, device):
    """-log(-log(u)), u = ``uniform(fold_in(PRNGKey(seed), pos), (V,),
    minval=1e-20)`` for each lane: (B,) seeds and positions -> (B, V)."""
    keys = prng.fold_in(prng.prng_key(seeds.to(device)), positions.to(device))
    return -torch.log(-torch.log(prng.uniform(keys, V, 1e-20, 1.0)))


def sample_tokens(logits, temps, top_ks, top_ps, seeds, positions):
    """The reference sampler over lanes: logits (B, V), per-lane temps,
    top_ks, top_ps, seeds and positions (B,) -> (B,) int32 (temp <= 0:
    greedy)."""
    logits = logits.float()
    lg = mask_top_p(mask_top_k(logits, top_ks), top_ps)
    lg = lg / temps.clamp(min=1e-6)[:, None]
    g = gumbel(seeds, positions, logits.shape[-1], logits.device)
    sampled = torch.argmax(lg + g, -1)
    return torch.where(temps <= 0.0, torch.argmax(logits, -1),
                       sampled).to(torch.int32)


# --------------------------------------------------------------------------- #
# the fast sampler: one top-k selection instead of two full-vocab sorts
# --------------------------------------------------------------------------- #
#: largest per-lane top_k the fast sampler handles exactly
TOPK_FAST_CAP = 64


def fast_eligible(sp: SamplingParams, vocab, k_cap=TOPK_FAST_CAP):
    """True when ``fast_sampler`` gives ``sample_tokens``' token for this
    request: greedy lanes ignore the masks, and a lane with
    ``1 <= top_k <= k_cap`` has both masks inside its top-k candidates."""
    return sp.temperature <= 0.0 or 0 < sp.top_k <= min(k_cap, vocab)


def fast_sampler(vocab, k_cap=TOPK_FAST_CAP):
    """A ``sample_tokens`` drop-in for lanes that satisfy ``fast_eligible``:
    the ``min(k_cap, vocab)`` highest logits (``torch.topk`` on the
    tie-free keys: ``lax.top_k``'s set and order), the top-p prefix over
    their softmax, and the full-vocab noise gathered onto them."""
    cap = int(min(k_cap, vocab))

    def sample(logits, temps, top_ks, top_ps, seeds, positions):
        logits = logits.float()
        kk = top_ks.clamp(1, cap)
        idx = torch.topk(order_keys(logits), cap, dim=-1).indices
        vals = torch.gather(logits, -1, idx)
        in_k = torch.arange(cap, device=logits.device)[None] < kk[:, None]
        sv = torch.where(in_k, vals, -torch.inf)
        sp = softmax(sv)
        keep = in_k & (((cumsum(sp) - sp) < top_ps[:, None])
                       | (top_ps >= 1.0)[:, None])
        keep[:, 0] = True
        lg = torch.where(keep, sv, -torch.inf) / temps.clamp(min=1e-6)[:, None]
        g = gumbel(seeds, positions, logits.shape[-1], logits.device)
        pick = torch.argmax(lg + torch.gather(g, -1, idx), -1, keepdim=True)
        sampled = torch.gather(idx, -1, pick)[:, 0]
        return torch.where(temps <= 0.0, torch.argmax(logits, -1),
                           sampled).to(torch.int32)

    return sample
