"""The tensor-core route of the chunk paged-attention kernel
(``csrc/paged_packed_tc.cuh`` over ``ChunkItems``: items of ``64 // G``
rows of one lane's chunk, one KV head and one key split, decoded from the
item index; each row's own key limit ``min(pos + c, pos + n_valid - 1)``;
key splits only below ``CHUNK_SPLIT_ITEMS`` row-tile items, merged in split
order) emulated in torch on the CPU, on bf16 pages and on int8 / fp8 pages
with row scales, against the port's plain version and the JAX package's
oracle (``ref.py`` ``paged_chunk_attention_ref``), on every row: rows past
``n_valid`` and rows that see no key included.

The emulation follows the kernel's rounding points, as
``tests/test_torch_packed_tiles.py``'s does for the packed layout: fp32
scores, the online softmax with exp2 and the scale folded in, P (or p *
v_scale as a bf16 hi/lo pair) rounded to bf16 for P.V, l summing the
unrounded p, fp32 partials per split combined in split order, the output
rounded to bf16 once.  Tolerances as there: 1e-5 without the two bf16
roundings (the plain version's fp32 arithmetic in another order), 2e-2
(``chip_smoke.py``'s ``ATTN_TOLS`` for bf16: one bf16 ulp of outputs below
4) with them."""
import math
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.kernels import ref as RREF  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from test_torch_packed_tiles import (LOG2E, TOL_BF16, TOL_FP32,  # noqa: E402
                                     _bf16, _quant_pools)

_REF = jax.jit(RREF.paged_chunk_attention_ref)


def chunk_items(B, C, *, G, Hkv, max_keys):
    """The chunk route's items in the kernel's order (lane, row tile, split,
    KV head fastest), as ``ChunkItems::item`` decodes them: (b, c0, n, s,
    hk), and the split length L."""
    R = PA.TILE_ROWS // G
    L = PA.chunk_split_keys(B, C, G=G, Hkv=Hkv, max_keys=max_keys)
    splits = -(-max_keys // L)
    items = [(b, c0, min(R, C - c0), s, hk) for b in range(B)
             for c0 in range(0, C, R) for s in range(splits)
             for hk in range(Hkv)]
    return items, L


def row_last(pos, n_valid, c):
    """The last key row c of a lane at (pos, n_valid) sees; -1: none."""
    return min(pos + c, pos + n_valid - 1)


def emulate_chunk_tc(q, k_pages, v_pages, block_tables, pos, n_valid, *,
                     round_bf16=True, k_scale=None, v_scale=None):
    """The kernel's arithmetic, item by item of ``chunk_items``: fp32 (B,
    C, H, D) output; with ``round_bf16``, P (or p * v_scale as a bf16
    pair) and the output rounded to bf16 where the kernel rounds them.
    One-byte pages come as their values in fp32 with (P, page) ``k_scale``
    / ``v_scale``.  Also returns the count of rows (b, c) written directly
    by an item, through the combine, and as zeros by an item that reads no
    key."""
    B, C, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G, Tb = H // Hkv, block_tables.shape[1]
    max_keys = Tb * page
    items, L = chunk_items(B, C, G=G, Hkv=Hkv, max_keys=max_keys)
    scale_log2 = D ** -0.5 * LOG2E
    rnd = _bf16 if round_bf16 else (lambda x: x)
    out = torch.full((B, C, H, D), math.nan)   # every row must be written
    parts = {}                                 # (s, b, c, h) -> (m, l, acc)
    direct, zeros = set(), set()
    for b, c0, n, s, hk in items:
        p, nv = int(pos[b]), int(n_valid[b])
        last = torch.tensor([row_last(p, nv, c0 + r // G)
                             for r in range(n * G)])
        k_begin = s * L
        k_end = min(int(last[-1]) + 1, max_keys, k_begin + L)
        if k_end <= k_begin:                   # no key of this split
            if s == 0:
                out[b, c0:c0 + n, hk * G:(hk + 1) * G] = 0.0
                zeros.update((b, c) for c in range(c0, c0 + n))
            continue
        pages = block_tables[b].long()
        keys = torch.arange(k_begin, k_end)
        rows = pages[keys // page] * page + keys % page
        k = k_pages.reshape(-1, Hkv, D)[rows, hk]
        v = v_pages.reshape(-1, Hkv, D)[rows, hk]
        if k_scale is not None:
            ks, vs = k_scale.reshape(-1)[rows], v_scale.reshape(-1)[rows]
        qr = q[b, c0:c0 + n, hk * G:(hk + 1) * G].reshape(n * G, D)
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
            pr = torch.exp2(sc - m_use[:, None])
            l = l * alpha + pr.sum(-1)
            if v_scale is None:
                pv = rnd(pr) @ vt
            else:
                x = pr * vs[j0:j0 + 64][None]
                pv = rnd(x) @ vt + rnd(x - rnd(x)) @ vt
            acc = acc * alpha[:, None] + pv
            m = m_new
        for r in range(n * G):
            c, h, lr = c0 + r // G, hk * G + r % G, int(last[r])
            if (s > 0) if lr < 0 else (lr < k_begin):
                continue
            if lr < 0 or -(-min(lr + 1, max_keys) // L) == 1:
                out[b, c, h] = rnd(acc[r] * (1.0 / max(float(l[r]), 1e-30)))
                direct.add((b, c))
            else:
                parts[(s, b, c, h)] = (m[r], l[r], acc[r])
    combined = set()
    for b in range(B):
        for c in range(C):
            lr = row_last(int(pos[b]), int(n_valid[b]), c)
            splits = -(-min(lr + 1, max_keys) // L) if lr >= 0 else 0
            if splits < 2:
                continue
            combined.add((b, c))
            for h in range(H):
                ps = [parts[(s, b, c, h)] for s in range(splits)]
                mx = max(float(pm) for pm, _, _ in ps)
                w = [2.0 ** (float(pm) - mx) for pm, _, _ in ps]
                lsum = sum(wi * float(pl) for wi, (_, pl, _) in zip(w, ps))
                a = sum(wi * pa for wi, (_, _, pa) in zip(w, ps))
                out[b, c, h] = rnd(a / max(lsum, 1e-30))
    return out, len(direct), len(combined), len(zeros)


#: (page, G, D, C, Hkv, splits): the route with key splits (few row-tile
#: items; a 512-key table, two 256-key splits) at G = 1, 3, 8 and D = 32,
#: 64, 128, C not a multiple of 64 / G; and without them (row-tile items
#: at or above CHUNK_SPLIT_ITEMS)
CASES = [(4, 3, 64, 23, 2, True), (16, 1, 32, 70, 2, True),
         (16, 8, 128, 9, 2, True), (4, 1, 32, 128, 16, False),
         (16, 8, 64, 40, 8, False)]


def _lanes(C, max_keys):
    """Eight lanes (pos, n_valid): a full chunk at 0; n_valid 0 at pos 0
    (no row sees a key) and at pos > 0; one valid row; n_valid < C across
    the 256-key split boundary; a full chunk across it; pos + C past the
    table's end; a full chunk near it."""
    return [(0, C), (0, 0), (5, 1), (250, max(C - 3, 1)), (300, 0),
            (256 - C // 2, C), (max_keys - C // 2, C // 2),
            (max_keys - C - 1, C)]


def _case(page, G, D, C, Hkv, seed):
    """bf16 values (as fp32 numpy) of one chunk call over ``_lanes``: q (B,
    C, H, D), pools (P, page, Hkv, D) of 512-key tables, distinct random
    pages per lane, pos, n_valid."""
    rng = np.random.default_rng(seed)
    Tb = 512 // page
    lanes = _lanes(C, Tb * page)
    B, P = len(lanes), len(lanes) * Tb + 1
    bt = (rng.permutation(np.arange(1, P))[:B * Tb].reshape(B, Tb)
          .astype(np.int32))

    def rnd(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return _bf16(torch.from_numpy(x)).numpy()

    return (rnd(B, C, G * Hkv, D), rnd(P, page, Hkv, D), rnd(P, page, Hkv, D),
            bt, np.array([p for p, _ in lanes], np.int32),
            np.array([n for _, n in lanes], np.int32))


def _check_counts(case, pos, n_valid, n_direct, n_combined, n_zero):
    """Every row is written exactly one way; the split route combines the
    rows whose keys cross 256, the other route none; the lane at (0, 0)
    is all zeros."""
    C, splits = case[3], case[5]
    B = len(pos)
    assert n_direct + n_combined + n_zero == B * C
    assert n_zero == C                           # lane (0, 0) only
    assert (n_combined > 0) == splits


@pytest.mark.parametrize("case", CASES)
def test_chunk_tile_algorithm_matches_plain_and_oracle(case):
    page, G, D, C, Hkv, _ = case
    args = _case(page, G, D, C, Hkv, seed=page * G + C)
    q, kp, vp, bt, pos, nv = (torch.from_numpy(a) for a in args)
    plain = PA.paged_chunk_attention_plain(q, kp, vp, bt, pos, nv)
    oracle = torch.from_numpy(np.array(_REF(*args)))
    exact, n_direct, n_combined, n_zero = emulate_chunk_tc(
        q, kp, vp, bt, pos, nv, round_bf16=False)
    _check_counts(case, pos, nv, n_direct, n_combined, n_zero)
    for want in (plain, oracle):
        np.testing.assert_allclose(exact.numpy(), want.numpy(),
                                   atol=TOL_FP32, rtol=0)
    emu, _, _, _ = emulate_chunk_tc(q, kp, vp, bt, pos, nv)
    assert torch.equal(emu[1], torch.zeros_like(emu[1]))  # no visible key
    assert torch.equal(emu, _bf16(emu))                   # bf16 values
    for want in (plain, oracle):
        err = (emu - want).abs().max().item()
        assert err <= TOL_BF16, err


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("case", CASES)
def test_quantized_chunk_tile_algorithm_matches_plain_and_oracle(case, kv):
    """The one-byte route (exact widening to bf16, k_scale on the score
    columns in fp32, p * v_scale into P.V as a bf16 pair) on every row."""
    page, G, D, C, Hkv, _ = case
    q, _, _, bt, pos, nv = _case(page, G, D, C, Hkv, seed=page * G + C)
    ref, port = _quant_pools(kv, len(pos) * bt.shape[1] + 1, page, Hkv, D,
                             seed=page * G + 1)
    q_t, bt_t, pos_t, nv_t = (torch.from_numpy(a) for a in (q, bt, pos, nv))
    kp, vp = port["k"], port["v"]
    scales = dict(k_scale=port["k_scale"], v_scale=port["v_scale"])
    plain = PA.paged_chunk_attention_plain(q_t, kp, vp, bt_t, pos_t, nv_t,
                                           **scales)
    oracle = torch.from_numpy(np.array(_REF(
        q, ref["k"], ref["v"], bt, pos, nv, k_scale=ref["k_scale"],
        v_scale=ref["v_scale"])))
    assert plain.abs().max() > 0.5                # outputs of order 1
    exact, n_direct, n_combined, n_zero = emulate_chunk_tc(
        q_t, kp.float(), vp.float(), bt_t, pos_t, nv_t, round_bf16=False,
        **scales)
    _check_counts(case, pos, nv, n_direct, n_combined, n_zero)
    for want in (plain, oracle):
        np.testing.assert_allclose(exact.numpy(), want.numpy(),
                                   atol=TOL_FP32, rtol=0)
    emu, _, _, _ = emulate_chunk_tc(q_t, kp.float(), vp.float(), bt_t, pos_t,
                                    nv_t, **scales)
    assert torch.equal(emu[1], torch.zeros_like(emu[1]))
    assert torch.equal(emu, _bf16(emu))
    for want in (plain, oracle):
        err = (emu - want).abs().max().item()
        assert err <= TOL_BF16, err


@pytest.mark.parametrize("case", CASES)
def test_chunk_items_cover_every_visible_key_once(case):
    """Every (row, head, visible key) of the call lies in exactly one item's
    rows and key range [k_begin, k_end): the items' spans of a row tile its
    visible keys (none for a row that sees no key)."""
    page, G, D, C, Hkv, splits = case
    Tb = 512 // page
    max_keys = Tb * page
    lanes = _lanes(C, max_keys)
    B = len(lanes)
    items, L = chunk_items(B, C, G=G, Hkv=Hkv, max_keys=max_keys)
    assert (L < max_keys) == splits
    assert len(items) == B * -(-C // (PA.TILE_ROWS // G)) \
        * -(-max_keys // L) * Hkv
    spans = {}                           # (b, c, h) -> [(k0, k1), ...]
    for b, c0, n, s, hk in items:
        p, nv = lanes[b]
        assert 1 <= n <= PA.TILE_ROWS // G and 0 <= hk < Hkv
        k_begin = s * L
        k_end = min(row_last(p, nv, c0 + n - 1) + 1, max_keys, k_begin + L)
        for c in range(c0, c0 + n):
            k1 = min(k_end, row_last(p, nv, c) + 1)
            if k1 > k_begin:
                for g in range(G):
                    spans.setdefault((b, c, hk * G + g), []).append(
                        (k_begin, k1))
    for b, (p, nv) in enumerate(lanes):
        for c in range(C):
            n_keys = min(row_last(p, nv, c) + 1, max_keys)
            for h in range(G * Hkv):
                got = sorted(spans.pop((b, c, h), []))
                # the spans tile [0, n_keys) without gaps or overlaps
                ends = [0] + [k1 for _, k1 in got]
                assert [k0 for k0, _ in got] == ends[:-1]
                assert ends[-1] == max(n_keys, 0)
    assert not spans                      # no row outside the call


@pytest.mark.parametrize("B,C,G,Hkv,max_keys,L", [
    (1, 128, 3, 8, 2048, 256), (8, 128, 3, 8, 2048, 2048),
    (2, 128, 3, 8, 2048, 256), (4, 128, 3, 8, 2048, 2048),
    (5, 128, 3, 8, 2048, 2048),
    (2, 1, 1, 8, 512, 256), (32, 64, 1, 8, 100, 100)])
def test_chunk_split_rule_mirrors_the_kernel_source(B, C, G, Hkv, max_keys,
                                                     L):
    """``chunk_split_keys`` and the tile constants against
    csrc/paged_packed_tc.cuh's: splits below CHUNK_SPLIT_ITEMS row-tile
    items (8 lanes x 7 tiles x 8 KV heads at the padded prefill's shape
    take none, nor do 4 lanes; one or two lanes take the packed cut), the
    whole table otherwise."""
    src = (pathlib.Path(PA.__file__).parent / "csrc"
           / "paged_packed_tc.cuh").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kChunkSplitItems"]) == PA.CHUNK_SPLIT_ITEMS
    assert int(const["kRows"]) == PA.TILE_ROWS
    assert int(const["kKeys"]) == PA.TILE_KEYS
    assert PA.chunk_split_keys(B, C, G=G, Hkv=Hkv, max_keys=max_keys) == L


@pytest.mark.cuda
def test_chunk_kernel_matches_the_emulation_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for case in CASES:
        for kv in ("", "int8", "fp8"):
            page, G, D, C, Hkv, _ = case
            args = [torch.from_numpy(a) for a in _case(page, G, D, C, Hkv,
                                                       seed=page * G + C)]
            q, kp, vp, bt, pos, nv = args
            scales = {}
            if kv:
                _, port = _quant_pools(kv, kp.shape[0], page, Hkv, D,
                                       seed=page * G + 1)
                kp, vp = port["k"], port["v"]
                scales = dict(k_scale=port["k_scale"],
                              v_scale=port["v_scale"])
            card = [a.cuda() for a in (q, kp, vp, bt, pos, nv)]
            card[0] = card[0].to(torch.bfloat16)
            if not kv:
                card[1:3] = [a.to(torch.bfloat16) for a in card[1:3]]
            cs = {n: x.cuda() for n, x in scales.items()}
            out = PA.paged_chunk_attention(*card, **cs)
            again = PA.paged_chunk_attention(*card, **cs)
            emu, _, _, _ = emulate_chunk_tc(q, kp.float(), vp.float(), bt,
                                            pos, nv, **scales)
            # exp2 and the reciprocal are approximate on the card: one ulp
            assert (out.float().cpu() - emu).abs().max().item() <= TOL_BF16
            assert torch.equal(out, again)
            assert torch.equal(out[1], torch.zeros_like(out[1]))
