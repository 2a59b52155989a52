"""The port's paged decode and chunk kernels: their plain versions against
the JAX package's oracles (``ref.py``) and Pallas kernels (interpret mode),
their dispatchers' telemetry and argument checks, and (on a card only) the
CUDA kernels against the plain versions."""
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.kernels import paged_attention as RPA  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402

TOL = 1e-5          # fp32 on both sides; softmax sums in another order
SHAPES = list(itertools.product((4, 8, 16), (32, 64, 128), (1, 2, 3, 4)))
_DEC_REF = jax.jit(RREF.paged_attention_ref)
_CHUNK_REF = jax.jit(RREF.paged_chunk_attention_ref)
C = 5


def _pools(rng, page, D, Hkv, Tb, B):
    P = B * Tb + 2
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:B * Tb].reshape(B, Tb) \
        .astype(np.int32)
    return kp, vp, bt


def _decode_case(page, D, G, Hkv=2, seed=0):
    """Four lanes: one key, exactly one page, the full table, and a
    length inside a page."""
    rng = np.random.default_rng(seed)
    Tb, B = 40 // page + 2, 4
    kp, vp, bt = _pools(rng, page, D, Hkv, Tb, B)
    q = rng.standard_normal((B, G * Hkv, D)).astype(np.float32)
    seq_lens = np.array([1, page, Tb * page, 2 * page + 3], np.int32)
    return q, kp, vp, bt, seq_lens


def _chunk_case(page, D, G, Hkv=2, seed=0):
    """Six lanes of a C = 5 chunk: n_valid C, 0, 1 and < C, at pos 0 and
    pos > 0 (the n_valid == 0 lanes at both)."""
    rng = np.random.default_rng(seed)
    lanes = [(0, C), (0, 0), (7, 1), (13, 3), (9, 0), (18, C)]
    B = len(lanes)
    Tb = (max(p for p, _ in lanes) + C) // page + 1
    kp, vp, bt = _pools(rng, page, D, Hkv, Tb, B)
    q = rng.standard_normal((B, C, G * Hkv, D)).astype(np.float32)
    pos = np.array([p for p, _ in lanes], np.int32)
    n_valid = np.array([n for _, n in lanes], np.int32)
    return q, kp, vp, bt, pos, n_valid


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("page,D,G", SHAPES)
def test_decode_plain_matches_oracle_and_pallas_interpret(page, D, G):
    args = _decode_case(page, D, G, seed=page * D + G)
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(_DEC_REF(*jargs))
    pallas = np.asarray(RPA.paged_decode_attention(*jargs, interpret=True))
    out = ops.paged_decode_attention(*_torch(args)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=TOL, rtol=0)


@pytest.mark.parametrize("page,D,G", SHAPES)
def test_chunk_plain_matches_oracle_and_pallas_interpret(page, D, G):
    args = _chunk_case(page, D, G, seed=page * D + G)
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(_CHUNK_REF(*jargs))
    pallas = np.asarray(RPA.paged_chunk_attention(*jargs, interpret=True))
    out = ops.paged_chunk_attention(*_torch(args)).numpy()
    # every row, the ones past n_valid included
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=TOL, rtol=0)
    assert np.all(out[1] == 0.0)          # n_valid 0 at pos 0: nothing seen


def test_decode_plain_follows_ref_on_empty_lanes():
    """seq_len == 0: ref.py gives the mean of V (softmax over all -1e30),
    the Pallas kernel 0; the plain version follows ref.py."""
    q, kp, vp, bt, seq_lens = _decode_case(4, 32, 2)
    seq_lens[0] = 0
    ref = np.asarray(_DEC_REF(*[jnp.asarray(a) for a in
                                (q, kp, vp, bt, seq_lens)]))
    out = PA.paged_decode_attention_plain(
        *_torch((q, kp, vp, bt, seq_lens))).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    assert np.abs(out[0]).max() > 0


@pytest.mark.parametrize("fn,case", [
    (PA.paged_decode_attention, _decode_case),
    (PA.paged_chunk_attention, _chunk_case)])
def test_plain_keeps_query_dtype(fn, case):
    args = _torch(case(8, 32, 3))
    q = args[0].to(torch.bfloat16)
    out = fn(q, *args[1:])
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize("site,case", [
    ("paged_decode_attention", _decode_case),
    ("paged_chunk_attention", _chunk_case)])
def test_dispatch_records_executed_cpu_calls(site, case):
    ops.reset_dispatch_paths()
    ops.reset_launches()
    for _ in range(2):
        getattr(ops, site)(*_torch(case(4, 32, 2)))
    assert ops.dispatch_paths() == {site: ops.PLAIN}
    assert set(ops.launch_counts().values()) == {0}   # plain never counts


@pytest.mark.parametrize("site,case", [
    ("paged_decode_attention", _decode_case),
    ("paged_chunk_attention", _chunk_case)])
def test_scale_pools_raise(site, case):
    """Scale pools no longer raise: fp8 pools with (P, page) row scales run
    the plain scale variant on the CPU, equal to the unquantized plain
    version on the dequantized pools, under the ``.fp8`` site label."""
    q, kp, vp, *idx = _torch(case(4, 32, 2))
    ks = torch.rand(kp.shape[:2]) + 0.5
    vs = torch.rand(kp.shape[:2]) + 0.5
    k8, v8 = kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn)
    ops.reset_dispatch_paths()
    out = getattr(ops, site)(q, k8, v8, *idx, k_scale=ks, v_scale=vs)
    want = getattr(ops, site)(q, k8.float() * ks[..., None, None],
                              v8.float() * vs[..., None, None], *idx)
    assert torch.equal(out, want)
    assert ops.dispatch_paths() == {f"{site}.fp8": ops.PLAIN, site: ops.PLAIN}


@pytest.mark.parametrize("check,launch,case", [
    (PA.check_decode_args, PA.paged_decode_attention_cuda, _decode_case),
    (PA.check_chunk_args, PA.paged_chunk_attention_cuda, _chunk_case)])
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(check, launch,
                                                             case):
    args = _torch(case(4, 32, 2))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        check(*args)
    # the CUDA entry checks before it builds or launches anything
    with pytest.raises(ValueError, match="CUDA"):
        launch(*args)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for (page, D, G), dtype in itertools.product(
            ((4, 32, 1), (8, 64, 3), (16, 128, 3), (16, 128, 4)),
            (torch.float32, torch.bfloat16)):
        # fp32: sums in another order; bf16: one output rounding
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for case, kernel, plain in (
                (_decode_case, PA.paged_decode_attention_cuda,
                 PA.paged_decode_attention_plain),
                (_chunk_case, PA.paged_chunk_attention_cuda,
                 PA.paged_chunk_attention_plain)):
            args = [t.cuda() for t in _torch(case(page, D, G))]
            q, kp, vp = (t.to(dtype) for t in args[:3])
            out = kernel(q, kp, vp, *args[3:])
            ref = plain(q.float(), kp.float(), vp.float(), *args[3:])
            torch.cuda.synchronize()
            err = (out.float() - ref.to(dtype).float()).abs().max()
            assert err.item() <= tol
