"""The port's flash-attention module: its plain forward against the JAX
package's ``blockwise_attention``, ``ref.attention_ref`` (Sq == Sk only: it
aligns causally at the end, the kernels at the start) and the Pallas kernel
in interpret mode; its plain backward against ``jax.vjp`` of the reference's
``blockwise_attention`` and torch autograd through the plain forward; the
dispatcher; and (on a card only) the CUDA kernels against the plain
versions.  fp32 throughout; tolerance 1e-5 (sums in another order, values
of order 1)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

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
    and logit softcap; the dispatcher (and so the kernels) takes neither."""
    q, k, v, _ = _case(1, 50, 1, 2, 32, seed=4)
    got = TA.blockwise_attention(*_t(q, k, v), window=8, cap=30.0,
                                 block_q=16)
    want = RA.blockwise_attention(*map(jnp.asarray, (q, k, v)), window=8,
                                  cap=30.0, block_q=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    for kw in (dict(window=8), dict(cap=30.0)):
        with pytest.raises(ValueError, match="sliding window"):
            ops.flash_attention(*_t(q, k, v), **kw)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, do = _t(*_case(1, 8, 1, 2, 32))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        FA.flash_attention_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        FA.check_kernel_args(q, k, v, o=q, dout=do)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for (B, S, Hkv, G, D, causal), dtype in zip(
            SHAPES + [(1, 300, 2, 3, 128, True)],
            [torch.float32, torch.bfloat16] * 4):
        q, k, v, do = (t.cuda().to(dtype)
                       for t in _t(*_case(B, S, Hkv, G, D)))
        o, lse = FA.flash_attention_fwd_cuda(q, k, v, causal=causal)
        r_o, r_lse = FA.flash_attention_plain(q, k, v, causal=causal)
        grads = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                            causal=causal)
        again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                            causal=causal)
        plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal)
        torch.cuda.synchronize()
        # fp32: sums in another order; bf16: one rounding of each output
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        assert (o.float() - r_o.float()).abs().max().item() <= tol
        assert (lse - r_lse).abs().max().item() <= 1e-4
        for a, b, c in zip(grads, again, plain):
            assert torch.equal(a, b)
            scale = c.float().abs().max().item()
            assert (a.float() - c.float()).abs().max().item() <= tol * scale
