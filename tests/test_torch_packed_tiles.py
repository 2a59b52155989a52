"""The tensor-core packed paged-attention kernel's algorithm (runs, work
items, 64-key tiles, key splits and their combine:
``csrc/paged_packed_tc.cuh``) emulated in torch on the CPU, on bf16 pages
and on int8 / fp8 pages with row scales, against the port's plain version
and the JAX package's oracle (``ref.py`` ``paged_packed_attention_ref``),
and the plain work-list builder the card's plan kernel is held against.

The emulation follows the kernel's rounding points: bf16 Q, K and V; fp32
scores; the online softmax in fp32 with exp2 and the scale folded in; P
rounded to bf16 for P.V (l sums the unrounded P); fp32 partials (m, l,
unnormalised accumulator) per split, combined in split order; the output
rounded to bf16 once.  Tolerances: without the two bf16 roundings the
algorithm is the plain version's fp32 arithmetic in another order, so 1e-5;
with them, ``chip_smoke.py``'s ``ATTN_TOLS`` for bf16, 2e-2: the output's
rounding is one bf16 ulp (at most 2^-7 = 0.0078 for |o| < 2, 0.0156 below
4), and rounding P (relative 2^-9 per weight, weights summing to 1) moves o
by at most 2^-9 max|v|, 0.0078 for |v| < 4.

On one-byte pages the kernel widens the int8 / e4m3 values to bf16 (exact:
every such value is a bf16 value), multiplies score column j by scale *
k_scale[j] in fp32, and feeds x = p * v_scale[j] to P.V as the bf16 pair
bf16(x) + bf16(x - bf16(x)) (x to 2^-17), while l sums the unscaled p: the
same two tolerances hold."""
import itertools
import math
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.kernels import ref as RREF  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402

TOL_FP32 = 1e-5
TOL_BF16 = 2e-2
LOG2E = 1.4426950408889634
_REF = jax.jit(RREF.paged_packed_attention_ref)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tick(page, G, D, Hkv=2, seed=0):
    """One packed tick with every case the kernel must take, bf16 values
    (as fp32 numpy arrays): slot 0 a 70-token prefill run from position 0
    (longer than a 64-key tile and than one item's 64 / G tokens, not a
    multiple of either), then 3 padding rows in slot 0; slot 1 a 20-token
    run at 245..264, across the first split boundary (256 keys); slot 2
    one token with one key (position 0); slot 3 one token at 300 (two
    splits); slot 4 as two runs, positions 10..12 and 13..14 with slot 2's
    token between them.  Table width Tb * page = 512 keys."""
    rng = np.random.default_rng(seed)
    Tb = 512 // page
    S, P = 5, 5 * Tb + 1
    H = G * Hkv
    bt = (rng.permutation(np.arange(1, P))[:S * Tb].reshape(S, Tb)
          .astype(np.int32))
    runs = [(0, range(70)), (0, [-1] * 3), (1, range(245, 265)),
            (4, range(10, 13)), (2, [0]), (4, range(13, 15)), (3, [300])]
    tok_slot = np.array([s for s, ps in runs for _ in ps], np.int32)
    tok_pos = np.array([p for _, ps in runs for p in ps], np.int32)

    def rnd(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return _bf16(torch.from_numpy(x)).numpy()

    return (rnd(len(tok_pos), H, D), rnd(P, page, Hkv, D),
            rnd(P, page, Hkv, D), bt, tok_slot, tok_pos)


def _quant_pools(kv, P, page, Hkv, D, seed):
    """int8 / fp8 e4m3 K/V pools with their (P, page) fp32 row scales, as
    ``tests/test_torch_quantized_kv.py``'s ``_pools`` builds them: numpy
    in the reference's dtypes, and the port's tensors of the same bytes
    (``interop.cache_from_numpy``).  The fp8 codes are clipped to e4m3's
    +-448 (these pools are large enough to hold values past it, which
    would cast to NaN) and their scales carry 127 / 448, so that both
    types' rows dequantize to the same range, |v * v_scale| < 4, as the
    engine's quantizer (scale = row amax / code max) makes them."""
    rng = np.random.default_rng(seed)
    shape = (P, page, Hkv, D)
    if kv == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        unit = 1.0
    else:
        k, v = (np.asarray(jnp.asarray(np.clip(
            rng.standard_normal(shape) * 100, -448, 448)).astype(
                jnp.float8_e4m3fn)) for _ in range(2))
        unit = 127 / 448
    ks, vs = (rng.uniform(0.002, 0.03, (P, page)).astype(np.float32)
              * np.float32(unit) for _ in range(2))
    ref = dict(k=k, v=v, k_scale=ks, v_scale=vs)
    return ref, interop.cache_from_numpy(ref, "cpu")


def emulate_packed_tc(q, k_pages, v_pages, block_tables, tok_slot, tok_pos,
                      *, round_bf16=True, k_scale=None, v_scale=None):
    """The kernel's arithmetic, item by item of ``PA.packed_work_list``:
    fp32 (T, H, D) output; with ``round_bf16``, P (or p * v_scale, as a
    bf16 pair) and the output rounded to bf16 where the kernel rounds
    them.  One-byte pages come as their values in fp32 with (P, page)
    ``k_scale`` / ``v_scale``.  Also returns the number of tokens written
    directly by an item and through the combine."""
    T, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G, Tb = H // Hkv, block_tables.shape[1]
    max_keys = Tb * page
    L = PA.split_keys(max_keys)
    scale_log2 = D ** -0.5 * LOG2E
    rnd = _bf16 if round_bf16 else (lambda x: x)
    out = torch.zeros(T, H, D)
    parts = {}                                  # (s, t, h) -> (m, l, acc)
    direct = set()
    for t0, n, s, hk in PA.packed_work_list(
            tok_slot, tok_pos, G=G, Hkv=Hkv, page=page, Tb=Tb).tolist():
        p0 = int(tok_pos[t0])
        pages = block_tables[int(tok_slot[t0])].long()
        k_begin = s * L
        k_end = min(p0 + n, max_keys, k_begin + L)
        keys = torch.arange(k_begin, k_end)
        rows = pages[keys // page] * page + keys % page
        k = k_pages.reshape(-1, Hkv, D)[rows, hk]          # (keys, D)
        v = v_pages.reshape(-1, Hkv, D)[rows, hk]
        if k_scale is not None:                            # key row scales
            ks, vs = k_scale.reshape(-1)[rows], v_scale.reshape(-1)[rows]
        qr = q[t0:t0 + n, hk * G:(hk + 1) * G].reshape(n * G, D)
        last = p0 + torch.arange(n * G) // G               # row positions
        m = torch.full((n * G,), -math.inf)
        l = torch.zeros(n * G)
        acc = torch.zeros(n * G, D)
        for j0 in range(0, k_end - k_begin, PA.TILE_KEYS):
            kt, vt = k[j0:j0 + 64], v[j0:j0 + 64]
            if k_scale is None:
                sc = (qr @ kt.T) * scale_log2
            else:
                sc = (qr @ kt.T) * (ks[j0:j0 + 64] * scale_log2)[None]
            vis = keys[j0:j0 + 64][None] <= last[:, None]
            sc = torch.where(vis, sc, -math.inf)
            m_new = torch.maximum(m, sc.max(-1).values)
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(sc - m_use[:, None])
            l = l * alpha + p.sum(-1)
            if v_scale is None:
                pv = rnd(p) @ vt
            else:
                x = p * vs[j0:j0 + 64][None]
                pv = rnd(x) @ vt + rnd(x - rnd(x)) @ vt
            acc = acc * alpha[:, None] + pv
            m = m_new
        for r in range(n * G):
            t, h, pos = t0 + r // G, hk * G + r % G, int(last[r])
            if pos < k_begin:
                continue
            if -(-min(pos + 1, max_keys) // L) == 1:
                out[t, h] = rnd(acc[r] * (1.0 / max(float(l[r]), 1e-30)))
                direct.add(t)
            else:
                parts[(s, t, h)] = (m[r], l[r], acc[r])
    combined = set()
    for t in range(T):
        pos = int(tok_pos[t])
        splits = -(-min(pos + 1, max_keys) // L) if pos >= 0 else 0
        if splits < 2:
            continue
        combined.add(t)
        for h in range(H):
            ps = [parts[(s, t, h)] for s in range(splits)]
            mx = max(float(pm) for pm, _, _ in ps)
            w = [2.0 ** (float(pm) - mx) for pm, _, _ in ps]
            lsum = sum(wi * float(pl) for wi, (_, pl, _) in zip(w, ps))
            a = sum(wi * pa for wi, (_, _, pa) in zip(w, ps))
            out[t, h] = rnd(a / max(lsum, 1e-30))
    return out, len(direct), len(combined)


CASES = [(page, G, D) for page, (G, D) in
         ((4, (1, 32)), (16, (1, 128)), (4, (3, 64)), (16, (3, 32)),
          (4, (8, 128)), (16, (8, 64)))]


@pytest.mark.parametrize("page,G,D", CASES)
def test_tiled_split_algorithm_matches_plain_and_oracle(page, G, D):
    args = _tick(page, G, D)
    q, kp, vp, bt, tok_slot, tok_pos = (torch.from_numpy(a) for a in args)
    plain = PA.paged_packed_attention_plain(q, kp, vp, bt, tok_slot, tok_pos)
    oracle = torch.from_numpy(np.array(_REF(*args)))
    live = tok_pos >= 0
    exact, n_direct, n_combined = emulate_packed_tc(
        q, kp, vp, bt, tok_slot, tok_pos, round_bf16=False)
    # both write paths and the padding rows are exercised
    assert n_direct > 0 and n_combined == 10
    np.testing.assert_allclose(exact[live].numpy(), plain[live].numpy(),
                               atol=TOL_FP32, rtol=0)
    np.testing.assert_allclose(exact[live].numpy(), oracle[live].numpy(),
                               atol=TOL_FP32, rtol=0)
    emu, _, _ = emulate_packed_tc(q, kp, vp, bt, tok_slot, tok_pos)
    assert torch.equal(emu[~live], torch.zeros_like(emu[~live]))
    assert torch.equal(emu, _bf16(emu))            # bf16 values
    for want in (plain, oracle):
        err = (emu[live] - want[live]).abs().max().item()
        assert err <= TOL_BF16, err


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("page,G,D", CASES)
def test_quantized_tile_algorithm_matches_plain_and_oracle(page, G, D, kv):
    """The kernel's one-byte route (exact widening to bf16, scales in fp32
    on the score columns and on P.V's operand) on the edge tick: at fp32
    it is the plain version's and the oracle's arithmetic in another
    order, with its roundings within ``TOL_BF16``."""
    q, _, _, bt, tok_slot, tok_pos = _tick(page, G, D)
    P = 5 * bt.shape[1] + 1
    ref, port = _quant_pools(kv, P, page, 2, D, seed=page * G)
    args = [torch.from_numpy(a) for a in (q, bt, tok_slot, tok_pos)]
    q_t, bt_t, slot_t, pos_t = args
    kp, vp = port["k"], port["v"]
    scales = dict(k_scale=port["k_scale"], v_scale=port["v_scale"])
    # the widening to bf16 rounds nothing
    for pool in (kp, vp):
        assert torch.equal(pool.to(torch.bfloat16).float(), pool.float())
    plain = PA.paged_packed_attention_plain(q_t, kp, vp, bt_t, slot_t, pos_t,
                                            **scales)
    oracle = torch.from_numpy(np.array(_REF(
        q, ref["k"], ref["v"], bt, tok_slot, tok_pos, k_scale=ref["k_scale"],
        v_scale=ref["v_scale"])))
    live = pos_t >= 0
    assert plain[live].abs().max() > 0.5          # outputs of order 1
    exact, n_direct, n_combined = emulate_packed_tc(
        q_t, kp.float(), vp.float(), bt_t, slot_t, pos_t, round_bf16=False,
        **scales)
    assert n_direct > 0 and n_combined == 10
    for want in (plain, oracle):
        np.testing.assert_allclose(exact[live].numpy(), want[live].numpy(),
                                   atol=TOL_FP32, rtol=0)
    emu, _, _ = emulate_packed_tc(q_t, kp.float(), vp.float(), bt_t, slot_t,
                                  pos_t, **scales)
    assert torch.equal(emu[~live], torch.zeros_like(emu[~live]))
    assert torch.equal(emu, _bf16(emu))
    for want in (plain, oracle):
        err = (emu[live] - want[live]).abs().max().item()
        assert err <= TOL_BF16, err


@pytest.mark.parametrize("page,G,D", CASES)
def test_work_list_covers_every_live_row_once(page, G, D):
    """Every live (token, KV head) is in exactly one item of each split its
    chunk's keys need and in no other; padding is in no item; an item's
    tokens are one run's (one slot, consecutive positions), at most 64 / G
    of them."""
    Hkv = 2
    _, _, _, bt, tok_slot, tok_pos = _tick(page, G, D, Hkv=Hkv)
    Tb = bt.shape[1]
    items = PA.packed_work_list(torch.from_numpy(tok_slot),
                                torch.from_numpy(tok_pos), G=G, Hkv=Hkv,
                                page=page, Tb=Tb)
    assert items.dtype == torch.int32 and items.shape[1] == 4
    L = PA.split_keys(Tb * page)
    seen = {}
    for t0, n, s, hk in items.tolist():
        assert 1 <= n <= PA.TILE_ROWS // G and 0 <= hk < Hkv
        toks = range(t0, t0 + n)
        assert all(tok_slot[t] == tok_slot[t0] for t in toks)
        assert [tok_pos[t] for t in toks] == list(range(tok_pos[t0],
                                                        tok_pos[t0] + n))
        assert s * L < min(tok_pos[t0 + n - 1] + 1, Tb * page)
        for t in toks:
            seen.setdefault((t, hk), []).append(s)
    chunk_splits = {}
    for t0, n, s, hk in items.tolist():
        for t in range(t0, t0 + n):
            chunk_splits[t] = max(chunk_splits.get(t, 0), s + 1)
    live = [t for t in range(len(tok_pos)) if tok_pos[t] >= 0]
    assert set(seen) == {(t, hk) for t in live for hk in range(Hkv)}
    for (t, hk), splits in seen.items():
        assert splits == list(range(chunk_splits[t]))
    # the two runs of slot 4 stay two runs; slot 1's run crosses a split
    runs = {(t0, n) for t0, n, _, _ in items.tolist()}
    assert (73 + 20, 3) in runs and (73 + 20 + 3 + 1, 2) in runs
    assert max(s for _, _, s, _ in items.tolist()) == 1


@pytest.mark.parametrize("max_keys,splits", [(96, 1), (512, 2), (2048, 8),
                                             (4096, 8), (1000, 4)])
def test_split_keys_mirror_the_kernel_source(max_keys, splits):
    """The Python mirror of the kernel's tiling constants: the same values
    as csrc/paged_packed_tc.cuh's, split lengths that are whole 64-key
    tiles of at least 256 keys and at most 8 splits of a table."""
    src = (pathlib.Path(PA.__file__).parent / "csrc"
           / "paged_packed_tc.cuh").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kRows"]) == PA.TILE_ROWS
    assert int(const["kKeys"]) == PA.TILE_KEYS
    assert int(const["kMinSplit"]) == PA.MIN_SPLIT_KEYS
    assert int(const["kMaxSplits"]) == PA.MAX_SPLITS
    L = PA.split_keys(max_keys)
    assert L >= PA.MIN_SPLIT_KEYS and L % PA.TILE_KEYS == 0
    assert -(-max_keys // L) == splits <= PA.MAX_SPLITS


@pytest.mark.cuda
def test_kernel_and_plan_match_the_emulation_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for (page, G, D), kv in itertools.product(CASES, ("", "int8", "fp8")):
        args = [torch.from_numpy(a) for a in _tick(page, G, D)]
        q, kp, vp, bt, tok_slot, tok_pos = args
        scales = {}
        if kv:                                  # bf16 q on one-byte pages
            _, port = _quant_pools(kv, kp.shape[0], page, 2, D, seed=page)
            kp, vp = port["k"], port["v"]
            scales = dict(k_scale=port["k_scale"], v_scale=port["v_scale"])
        card = [a.cuda() for a in (q, kp, vp, bt, tok_slot, tok_pos)]
        card[0] = card[0].to(torch.bfloat16)
        if not kv:
            card[1:3] = [a.to(torch.bfloat16) for a in card[1:3]]
        items = PA.paged_packed_plan_cuda(card[0], card[0].new_empty(
            (1, page, 2, D)), *card[3:])
        assert torch.equal(items, PA.packed_work_list(
            tok_slot, tok_pos, G=G, Hkv=2, page=page, Tb=bt.shape[1]))
        out = PA.paged_packed_attention(
            *card, **{n: x.cuda() for n, x in scales.items()}).float().cpu()
        emu, _, _ = emulate_packed_tc(q, kp.float(), vp.float(), bt,
                                      tok_slot, tok_pos, **scales)
        live = tok_pos >= 0
        # exp2 and the reciprocal are approximate on the card: one bf16 ulp
        assert (out[live] - emu[live]).abs().max().item() <= TOL_BF16
        assert torch.equal(out[~live], torch.zeros_like(out[~live]))
