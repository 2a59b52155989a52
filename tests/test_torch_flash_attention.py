"""The port's flash-attention module: its plain forward against the JAX
package's ``blockwise_attention``, ``ref.attention_ref`` (Sq == Sk only: it
aligns causally at the end, the kernels at the start) and the Pallas kernel
in interpret mode; its plain backward against ``jax.vjp`` of the reference's
``blockwise_attention`` and torch autograd through the plain forward; the
dispatcher; an emulation of the bf16 tensor-core kernels' arithmetic (tile
sizes and bf16 rounding points) against the plain versions and the
reference; and (on a card only) the CUDA kernels against the plain
versions; all of it also with gemma2's sliding window and logit softcap.
fp32 tests: tolerance 1e-5 (sums in another order, values of order 1);
the bf16 emulation: ``chip_smoke.py``'s bf16 tolerances."""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.kernels import flash_attention as RFA  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

TOL = 1e-5

#: (B, S, Hkv, G, D, causal): S not a multiple of the 128-row Pallas block
#: nor of the port's 64-row tiles, G in {1, 2, 4}, D in {32, 64}
SHAPES = [(2, 37, 2, 1, 32, True), (1, 37, 1, 2, 64, True),
          (2, 100, 2, 4, 32, True), (1, 100, 1, 4, 64, False),
          (2, 70, 2, 2, 32, False), (1, 129, 1, 2, 64, True)]


def _case(B, S, Hkv, G, D, seed=0, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    q = rng.standard_normal((B, S, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, Hkv * G, D)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _lse_ref(q, k, causal, q_offset=0):
    """fp64 row log-sum-exp (B, H, Sq) of the scaled, masked scores."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // Hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * D ** -0.5
    if causal:
        mask = np.arange(k.shape[1])[None] <= q_offset + np.arange(Sq)[:, None]
        s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("B,S,Hkv,G,D,causal", SHAPES)
def test_plain_forward_matches_reference_oracle_and_pallas(B, S, Hkv, G, D,
                                                           causal):
    q, k, v, _ = _case(B, S, Hkv, G, D, seed=S + D)
    o, lse = FA.flash_attention_plain(*_t(q, k, v), causal=causal,
                                      block_q=32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for ref in (RA.blockwise_attention(jq, jk, jv, causal=causal,
                                       block_q=32),
                RREF.attention_ref(jq, jk, jv, causal=causal),
                RFA.flash_attention(jq, jk, jv, causal=causal,
                                    interpret=True)):
        np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse_ref(q, k, causal),
                               atol=TOL, rtol=0)
    # the port's blockwise_attention is the plain forward: the same bits
    assert torch.equal(o, TA.blockwise_attention(*_t(q, k, v), causal=causal,
                                                 block_q=32))


def test_q_offset_aligns_causally_at_the_start():
    """Sq < Sk with q_offset: key j is visible to query row i when
    j <= q_offset + i, as the reference's blockwise_attention (and not
    attention_ref, which aligns at the end)."""
    q, k, v, do = _case(2, 24, 2, 2, 32, seed=3, Sk=60)
    o, lse = FA.flash_attention_plain(*_t(q, k, v), q_offset=20, block_q=16)
    ref = RA.blockwise_attention(*map(jnp.asarray, (q, k, v)), block_q=16,
                                 q_offset=20)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse_ref(q, k, True, 20),
                               atol=TOL, rtol=0)
    grads = FA.flash_attention_bwd_plain(*_t(q, k, v), o, lse,
                                         torch.from_numpy(do), q_offset=20,
                                         block_q=16)
    _, vjp = jax.vjp(lambda a, b, c: RA.blockwise_attention(
        a, b, c, block_q=16, q_offset=20), *map(jnp.asarray, (q, k, v)))
    for got, want in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("B,S,Hkv,G,D,causal", SHAPES[:4])
def test_plain_backward_matches_jax_vjp_and_autograd(B, S, Hkv, G, D,
                                                     causal):
    q, k, v, do = _case(B, S, Hkv, G, D, seed=S * D)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = FA.flash_attention_plain(tq, tk, tv, causal=causal, block_q=32)
    grads = FA.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                         causal=causal, block_q=32)
    _, vjp = jax.vjp(lambda a, b, c: RA.blockwise_attention(
        a, b, c, causal=causal, block_q=32), *map(jnp.asarray, (q, k, v)))
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    TA.blockwise_attention(*leaves, causal=causal, block_q=32).backward(tdo)
    for got, want, auto in zip(grads, vjp(jnp.asarray(do)), leaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), auto.grad.numpy(), atol=TOL,
                                   rtol=0)


def test_dispatcher_function_runs_the_plain_versions_on_cpu():
    """``ops.flash_attention`` on CPU tensors: the autograd Function's
    forward is the plain forward and its backward the plain backward,
    recorded as ``cpu-plain``; no kernel launch is counted."""
    q, k, v, do = _t(*_case(1, 40, 2, 2, 32, seed=9))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_dispatch_paths()
    ops.reset_launches()
    out = ops.flash_attention(*leaves, block_q=16)
    out.backward(do)
    o, lse = FA.flash_attention_plain(q, k, v, block_q=16)
    assert torch.equal(out.detach(), o)
    for leaf, want in zip(leaves, FA.flash_attention_bwd_plain(
            q, k, v, o, lse, do, block_q=16)):
        assert torch.equal(leaf.grad, want)
    assert ops.dispatch_paths() == {"flash_attention": ops.PLAIN}
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention.bwd"] == 0


def test_blockwise_window_and_softcap_match_reference_dispatcher_raises():
    """The port's blockwise_attention carries the reference's sliding window
    and logit softcap; the dispatcher takes both (it raised before the
    kernels took them) and hands them to the plain versions on the CPU:
    its output and gradients are theirs, bit for bit, for a window alone, a
    cap alone and both."""
    q, k, v, do = _case(1, 50, 1, 2, 32, seed=4)
    got = TA.blockwise_attention(*_t(q, k, v), window=8, cap=30.0,
                                 block_q=16)
    want = RA.blockwise_attention(*map(jnp.asarray, (q, k, v)), window=8,
                                  cap=30.0, block_q=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    tq, tk, tv, tdo = _t(q, k, v, do)
    for kw in (dict(window=8), dict(cap=30.0), dict(window=8, cap=30.0)):
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        ops.reset_dispatch_paths()
        out = ops.flash_attention(*leaves, block_q=16, **kw)
        out.backward(tdo)
        o, lse = FA.flash_attention_plain(tq, tk, tv, block_q=16, **kw)
        assert torch.equal(out.detach(), o)
        for leaf, g in zip(leaves, FA.flash_attention_bwd_plain(
                tq, tk, tv, o, lse, tdo, block_q=16, **kw)):
            assert torch.equal(leaf.grad, g)
        assert ops.dispatch_paths() == {"flash_attention": ops.PLAIN}
        bare, _ = FA.flash_attention_plain(tq, tk, tv, block_q=16)
        assert not torch.equal(o, bare)      # the option took effect


#: (window, cap, q_offset) of the plain window / softcap cases: a window of
#: one key (the diagonal alone), 5, 64 (a 64-key tile) and past the end
#: (>= Sk: no window), each without and with the cap, at q_offset 0 and 36
WINDOW_CASES = [(w, cap, qo) for w in (1, 5, 64, 200) for cap in (0.0, 30.0)
                for qo in (0, 36)]


def _lse_window_ref(q, k, causal, q_offset, window, cap):
    """fp64 row log-sum-exp (B, H, Sq) of the scaled, softcapped, masked
    scores."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // Hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * D ** -0.5
    if cap:
        s = np.tanh(s / cap) * cap
    k_pos = np.arange(k.shape[1])[None]
    q_pos = q_offset + np.arange(Sq)[:, None]
    mask = k_pos <= q_pos if causal else np.ones_like(k_pos > q_pos)
    if window > 0:
        mask &= k_pos > q_pos - window
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("window,cap,q_offset", WINDOW_CASES)
def test_plain_window_and_softcap_match_reference_and_vjp(window, cap,
                                                          q_offset):
    """The plain forward (o, lse) and backward with a sliding window and a
    logit softcap against the reference's ``blockwise_attention`` and its
    ``jax.vjp`` (and an fp64 lse), Sq = 70 rows (Sk = 106 at q_offset 36);
    a window >= Sk gives the window-0 results bit for bit."""
    Sk = 70 + q_offset
    q, k, v, do = _case(2, 70, 2, 2, 32, seed=window + q_offset, Sk=Sk)
    kw = dict(window=window, cap=cap, q_offset=q_offset)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = FA.flash_attention_plain(tq, tk, tv, block_q=32, **kw)
    grads = FA.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                         block_q=32, **kw)
    ref, vjp = jax.vjp(lambda a, b, c: RA.blockwise_attention(
        a, b, c, block_q=32, **kw), *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(
        lse.numpy(), _lse_window_ref(q, k, True, q_offset, window, cap),
        atol=TOL, rtol=0)
    for got, want in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
    if window >= Sk:
        o0, lse0 = FA.flash_attention_plain(tq, tk, tv, block_q=32,
                                            **dict(kw, window=0))
        assert torch.equal(o, o0) and torch.equal(lse, lse0)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, do = _t(*_case(1, 8, 1, 2, 32))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        FA.flash_attention_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        FA.check_kernel_args(q, k, v, o=q, dout=do)


#: rows of each streamed tile of the bf16 kernels (csrc/flash_attention.cu,
#: namespace tc): K/V in the forward and dQ kernels, Q/dO in dK/dV
TILE = 64
#: chip_smoke.py's bf16 tolerances: FLASH_TOLS (o absolute, gradients
#: relative to the largest, kernel vs plain) and GRAD_TOLS (gradients vs
#: autograd through the plain forward, here vs the reference's jax.vjp)
BF16_TOL, BF16_GRAD_TOL = 3e-2, 5e-2
LOG2E = math.log2(math.e)

#: (B, S, Hkv, G, D, causal): S not a multiple of 64 or 128, D 32 / 64 /
#: 128, G 1 / 2 / 3, each S, D and G once causal and once full
TC_SHAPES = [(1, 77, 2, 3, 32, True), (1, 130, 1, 2, 64, True),
             (1, 200, 2, 1, 128, True), (2, 77, 1, 1, 64, False),
             (1, 130, 2, 3, 128, False), (1, 200, 1, 2, 32, False)]


def _heads(t, G=1):
    """(B, S, heads, D) -> fp32 (B, heads * G, S, D), each head repeated G
    times (K and V of a GQA group)."""
    return t.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)


def _visible(Sq, Sk, causal, window=0):
    k_pos, q_pos = torch.arange(Sk)[None], torch.arange(Sq)[:, None]
    vis = k_pos <= q_pos if causal else torch.ones(Sq, Sk, dtype=torch.bool)
    if window > 0:
        vis = vis & (k_pos > q_pos - window)
    return vis


def _round(x):
    return x.to(torch.bfloat16).float()


def _capped(s, scale, cap):
    """Raw scores -> (multiplier of the softmax's exp2, scores): without a
    cap (scale log2(e), s); with one the capped scores in log2 units,
    tanh(s * scale / cap) * cap * log2(e), and a unit multiplier."""
    if not cap:
        return scale * LOG2E, s
    return 1.0, torch.tanh(s * (scale / cap)) * (cap * LOG2E)


def emulate_tc_forward(q, k, v, causal, window=0, cap=0.0):
    """The bf16 forward kernel's arithmetic: scores of bf16 inputs summed in
    fp32, one TILE-key tile at a time; under a softcap each score becomes
    tanh(s * scale / cap) * cap * log2(e) before the mask; the running max
    in the log2 domain (scale folded in), the tile's p = exp2(s * scale *
    log2(e) - m) (capped: exp2(s_c - m)) summed unrounded into l and
    rounded to bf16 for P.V (fp32 sums); o = acc / l rounded to bf16, lse
    = (m + log2 l) ln 2.  A tile no row of the block sees changes nothing
    (p = 0, alpha = 1 or l = 0), so the kernel's skipping of tiles below the
    window needs no emulation."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    qf, kf, vf = _heads(q), _heads(k, G), _heads(v, G)
    vis = _visible(Sq, k.shape[1], causal, window)
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, D)
    for k0 in range(0, k.shape[1], TILE):
        sl = slice(k0, k0 + TILE)
        sl2, s = _capped(qf @ kf[:, :, sl].transpose(-1, -2), D ** -0.5,
                         cap)
        s = s.masked_fill(~vis[:, sl], -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * sl2)
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s * sl2 - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _round(p) @ vf[:, :, sl]
        m = m_new
    o = (acc / l[..., None]).permute(0, 2, 1, 3).to(torch.bfloat16)
    return o, (m + torch.log2(l)) * math.log(2)


def emulate_tc_backward(q, k, v, o, lse, do, causal, window=0, cap=0.0):
    """The bf16 backward kernels' arithmetic: delta = rowsum(dO * O) in
    fp32; per TILE-query tile (dK/dV kernel) P = exp2(s * scale *
    log2(e) - lse * log2(e)) (capped: t = tanh(s * scale / cap), P =
    exp2(t * cap * log2(e) - lse * log2(e))) rounded to bf16, dS = P (dP -
    delta) from that bf16 P in fp32 (capped: P ((dP - delta)(1 - t^2))),
    rounded to bf16, then dV += P^T dO and dK += dS^T Q; per TILE-key tile (dQ
    kernel) the same P and dS before dQ += dS K; fp32 sums, dK summed over
    the G heads of a group, each gradient rounded once."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    qf, kf, vf, dof = _heads(q), _heads(k, G), _heads(v, G), _heads(do)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    vis = _visible(Sq, Sk, causal, window)

    def p_ds(qs, ks):
        s = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)
        factor = 1.0
        if cap:
            t = torch.tanh(s * (scale / cap))
            p = torch.exp2(t * (cap * LOG2E) - lse[:, :, qs, None] * LOG2E)
            factor = 1 - t * t
        else:
            p = torch.exp2(s * scale * LOG2E - lse[:, :, qs, None] * LOG2E)
        p = _round(torch.where(vis[qs, ks], p, 0.0))
        dp = dof[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
        return p, _round(p * ((dp - delta[:, :, qs]) * factor))

    dk = torch.zeros(B, H, Sk, D)
    dv = torch.zeros(B, H, Sk, D)
    for q0 in range(0, Sq, TILE):
        qs, ks = slice(q0, q0 + TILE), slice(0, Sk)
        p, ds = p_ds(qs, ks)
        dv += p.transpose(-1, -2) @ dof[:, :, qs]
        dk += ds.transpose(-1, -2) @ qf[:, :, qs]
    dq = torch.zeros(B, H, Sq, D)
    for k0 in range(0, Sk, TILE):
        ks = slice(k0, k0 + TILE)
        _, ds = p_ds(slice(0, Sq), ks)
        dq += ds @ kf[:, :, ks]

    def out(t):                     # (B, heads, S, D) -> (B, S, heads, D)
        return t.permute(0, 2, 1, 3).to(torch.bfloat16)
    group = (B, Hkv, G, Sk, D)
    return (out(dq * scale), out(dk.reshape(group).sum(2) * scale),
            out(dv.reshape(group).sum(2)))


def _max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rel(a, b):
    return _max_abs(a, b) / b.float().abs().max().item()


#: (window, cap) of the bf16 emulation: none (every TC_SHAPES case), then
#: gemma2's options on three of them: a window of 70 keys (not a multiple
#: of the tiles) with the cap, the cap alone, a window of 2 alone (of 1,
#: dQ and dK are 0 up to rounding: P = 1 on the diagonal, dP = delta, and a
#: relative error has no scale)
TC_OPTIONS = [(0, 0.0)] * len(TC_SHAPES) + [(70, 50.0), (0, 50.0), (2, 0.0)]


@pytest.mark.parametrize("B,S,Hkv,G,D,causal,window,cap", [
    shape + opt for shape, opt in zip(TC_SHAPES + TC_SHAPES[:3], TC_OPTIONS)])
def test_bf16_kernel_rounding_points_fit_the_chip_tolerances(B, S, Hkv, G,
                                                             D, causal,
                                                             window, cap):
    """The bf16 kernels' arithmetic, emulated in torch on the CPU, against
    the plain versions and the reference's bf16 blockwise_attention and its
    jax.vjp, within the tolerances chip_smoke.py holds the kernels to; also
    with a sliding window and the softcap."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _case(B, S, Hkv, G, D, seed=S + D + G))
    kw = dict(causal=causal, window=window, cap=cap)
    o, lse = emulate_tc_forward(q, k, v, **kw)
    r_o, r_lse = FA.flash_attention_plain(q, k, v, **kw)
    assert _max_abs(o, r_o) <= BF16_TOL
    assert _max_abs(lse, r_lse) <= 1e-4
    grads = emulate_tc_backward(q, k, v, o, lse, do, **kw)
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for got, want in zip(grads, plain):
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= BF16_TOL
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                       for t in (q, k, v, do))
    ref_o, vjp = jax.vjp(lambda a, b, c: RA.blockwise_attention(
        a, b, c, block_q=S, **kw), jq, jk, jv)
    assert _max_abs(o, torch.from_numpy(np.asarray(ref_o, np.float32))) \
        <= BF16_TOL
    for got, want in zip(grads, vjp(jdo)):
        assert _rel(got, torch.from_numpy(np.asarray(want, np.float32))) \
            <= BF16_GRAD_TOL


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """fp32 cases run the CUDA-core kernels, bf16 cases the tensor-core
    kernels: every head dim, causal and full, S not a multiple of the tiles,
    G = 1 to 4, with and without a window and the softcap; each backward
    twice for the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = list(zip(SHAPES, [f32, bf16] * 3)) + [
        ((1, 300, 2, 3, 128, True), f32), ((1, 300, 2, 3, 128, True), bf16),
        ((2, 77, 2, 3, 32, True), bf16), ((1, 200, 2, 3, 128, False), bf16),
        ((1, 91, 2, 2, 32, False), bf16)]
    cases = [(c, dt, 0, 0.0) for c, dt in cases] + [
        (c, dt, w, cap) for c in ((1, 300, 2, 2, 128, True),
                                  (2, 77, 2, 3, 32, True))
        for dt in (f32, bf16) for w, cap in ((2, 0.0), (70, 50.0),
                                             (0, 50.0))]
    for (B, S, Hkv, G, D, causal), dtype, window, cap in cases:
        q, k, v, do = (t.cuda().to(dtype)
                       for t in _t(*_case(B, S, Hkv, G, D)))
        kw = dict(causal=causal, window=window, cap=cap)
        o, lse = FA.flash_attention_fwd_cuda(q, k, v, **kw)
        r_o, r_lse = FA.flash_attention_plain(q, k, v, **kw)
        grads = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        # fp32: sums in another order; bf16: one rounding of each output
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        assert (o.float() - r_o.float()).abs().max().item() <= tol
        assert (lse - r_lse).abs().max().item() <= 1e-4
        for a, b, c in zip(grads, again, plain):
            assert torch.equal(a, b)
            scale = c.float().abs().max().item()
            assert (a.float() - c.float()).abs().max().item() <= tol * scale
