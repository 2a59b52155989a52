"""The key-split paged decode attention of bf16 q on bf16, int8 and fp8
pages (``csrc/paged_decode_splits.cuh``: items of (lane, KV head, key
split), 64-key tiles, an online softmax per item, fp32 partials merged in
split order) emulated in torch on the CPU, against the JAX package's Pallas
decode kernel (interpret mode, with its k_scale / v_scale variant) and its
oracle (``ref.py`` ``paged_attention_ref``), on the edge lanes the card's
checks use and on one lane of odd H over three splits; and the split rule
against ``split_keys``, the packed kernel's.

The emulation follows the kernel's arithmetic: fp32 scores times the scale,
the reference's -1e30 mask, expf, acc * alpha + p v, a lane whose keys lie
in one split written by its item, the others merged as sum_s w_s acc_s /
sum_s w_s l_s with w_s = exp(m_s - max m), the output rounded to bf16 once.
On one-byte pages (pools quantized by the port's ``_quant_rows``) the
scales are folded as the kernel folds them: a score is ((q . k_raw) ks)
scale, P.V takes p vs, l sums p.
Tolerances: on fp32 values the emulation is the oracle's arithmetic in
another order, so 1e-5; with bf16 inputs and the output's rounding,
``chip_smoke.py``'s ``ATTN_TOLS`` for bf16, 2e-2 (one bf16 ulp of outputs
below 4)."""
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

from repro.kernels import paged_attention as RPA  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.models.attention import _quant_rows  # noqa: E402

TOL_FP32 = 1e-5
TOL_BF16 = 2e-2
HKV = 2
_REF = jax.jit(RREF.paged_attention_ref)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _lanes(max_keys):
    """The edge lanes: one key, both sides of the first and second split
    boundaries (256 and 512 keys), the whole table, and an empty lane."""
    return [1, 255, 256, 257, 511, 512, max_keys, 0]


def _case(page, Tb, G, D, seed):
    """bf16-valued inputs (as fp32 numpy) of the edge lanes: q (B, H, D),
    pools (P, page, Hkv, D), distinct random pages per lane."""
    rng = np.random.default_rng(seed)
    seq_lens = np.array(_lanes(Tb * page), np.int32)
    B, P = len(seq_lens), len(seq_lens) * Tb + 1
    bt = (rng.permutation(np.arange(1, P))[:B * Tb].reshape(B, Tb)
          .astype(np.int32))

    def rnd(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return _bf16(x).numpy()

    return (rnd(B, G * HKV, D), rnd(P, page, HKV, D), rnd(P, page, HKV, D),
            bt, seq_lens)


def split_ranges(seq_len, max_keys):
    """The key ranges [k_begin, k_end) of a lane's live items, split by
    split: splits of ``split_keys(max_keys)`` keys up to the lane's length
    (at most ``max_keys``)."""
    L = PA.split_keys(max_keys)
    n_keys = min(seq_len, max_keys)
    return [(k, min(n_keys, k + L)) for k in range(0, max(n_keys, 0), L)]


def emulate_decode_splits(q, k_pages, v_pages, block_tables, seq_lens, *,
                          round_bf16=True, k_scale=None, v_scale=None):
    """The kernel's arithmetic, item by item: fp32 (B, H, D) output,
    rounded to bf16 where the kernel rounds it with ``round_bf16``.
    One-byte pages come as their values in fp32 with (P, page)
    ``k_scale`` / ``v_scale``.  Also returns the number of lanes written
    directly and through the combine."""
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G, Tb = H // Hkv, block_tables.shape[1]
    max_keys = Tb * page
    scale = D ** -0.5
    rnd = _bf16 if round_bf16 else (lambda x: x)
    out = torch.zeros(B, H, D)
    n_direct = n_combined = 0
    for b in range(B):
        ranges = split_ranges(int(seq_lens[b]), max_keys)
        if not ranges:
            continue                                  # exact zeros
        pages = block_tables[b].long()
        for hk in range(Hkv):
            qr = q[b, hk * G:(hk + 1) * G]
            parts = []
            for k_begin, k_end in ranges:
                m = torch.full((G,), -1e30)
                l = torch.zeros(G)
                acc = torch.zeros(G, D)
                for k0 in range(k_begin, k_end, PA.TILE_KEYS):
                    keys = torch.arange(k0, min(k0 + PA.TILE_KEYS, k_end))
                    rows = pages[keys // page] * page + keys % page
                    kt = k_pages.reshape(-1, Hkv, D)[rows, hk]
                    vt = v_pages.reshape(-1, Hkv, D)[rows, hk]
                    s = qr @ kt.T
                    if k_scale is not None:       # ((q . k_raw) ks) scale
                        s = s * k_scale.reshape(-1)[rows][None]
                    s = s * scale
                    m_new = torch.maximum(m, s.max(-1).values)
                    p = torch.exp(s - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    pv = p if v_scale is None else \
                        p * v_scale.reshape(-1)[rows][None]
                    acc = acc * alpha[:, None] + pv @ vt
                    m = m_new
                parts.append((m, l, acc))
            if len(parts) == 1:
                _, l, acc = parts[0]
                o = acc / torch.clamp(l, min=1e-30)[:, None]
            else:
                mx = torch.stack([pm for pm, _, _ in parts]).max(0).values
                w = [torch.exp(pm - mx) for pm, _, _ in parts]
                lsum = sum(wi * pl for wi, (_, pl, _) in zip(w, parts))
                a = sum(wi[:, None] * pa for wi, (_, _, pa) in zip(w, parts))
                o = a / torch.clamp(lsum, min=1e-30)[:, None]
            out[b, hk * G:(hk + 1) * G] = rnd(o)
        if len(ranges) == 1:
            n_direct += 1
        else:
            n_combined += 1
    return out, n_direct, n_combined


#: (page, Tb, G, D): tables of 2048 keys (8 splits of 256) and 640 keys
#: (3 splits), G = 1, 3, 8 and D = 32, 64, 128
CASES = [(16, 128, 1, 32), (16, 40, 3, 64), (4, 160, 8, 128),
         (8, 80, 3, 128)]


@pytest.mark.parametrize("page,Tb,G,D", CASES)
def test_split_items_match_pallas_and_oracle(page, Tb, G, D):
    args = _case(page, Tb, G, D, seed=page * G + D)
    q, kp, vp, bt, seq_lens = (torch.from_numpy(a) for a in args)
    jargs = [jnp.asarray(a) for a in args]
    pallas = torch.from_numpy(np.array(
        RPA.paged_decode_attention(*jargs, interpret=True)))
    oracle = torch.from_numpy(np.array(_REF(*jargs)))
    live = seq_lens > 0
    exact, n_direct, n_combined = emulate_decode_splits(
        q, kp, vp, bt, seq_lens, round_bf16=False)
    # the one-split lanes (1, 255, 256 keys) and the merged ones (257 on)
    assert (n_direct, n_combined) == (3, 4)
    np.testing.assert_allclose(exact.numpy(), pallas.numpy(), atol=TOL_FP32,
                               rtol=0)
    np.testing.assert_allclose(exact[live].numpy(), oracle[live].numpy(),
                               atol=TOL_FP32, rtol=0)
    emu, _, _ = emulate_decode_splits(q, kp, vp, bt, seq_lens)
    # the empty lane: exact zeros, as the Pallas kernel writes them
    assert torch.equal(emu[~live], torch.zeros_like(emu[~live]))
    assert torch.equal(emu, _bf16(emu))                # bf16 values
    for want in (pallas, oracle):
        err = (emu[live] - want[live]).abs().max().item()
        assert err <= TOL_BF16, err
    # and the port's plain version (which follows ref.py on the empty lane)
    plain = PA.paged_decode_attention_plain(q, kp, vp, bt, seq_lens)
    np.testing.assert_allclose(exact[live].numpy(), plain[live].numpy(),
                               atol=TOL_FP32, rtol=0)


KV_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _quant_case(kv, page, Tb, G, D, seed, lens=None, Hkv=HKV):
    """The inputs of ``_case`` (or one-lane ``lens``) with fp32 K/V pools
    quantized by the port's ``_quant_rows`` to ``kv`` pages: (port args,
    the pools' values in fp32, the scales, the reference's numpy pools in
    their own dtypes)."""
    rng = np.random.default_rng(seed)
    seq_lens = np.array(lens or _lanes(Tb * page), np.int32)
    B = len(seq_lens)
    P = B * Tb + 1
    bt = (rng.permutation(np.arange(1, P))[:B * Tb].reshape(B, Tb)
          .astype(np.int32))
    q = _bf16(torch.from_numpy(
        rng.standard_normal((B, G * Hkv, D)).astype(np.float32)))
    dt = KV_DTYPES[kv]
    pools, values, scales, ref = [], [], [], []
    for _ in range(2):
        x = torch.from_numpy(
            rng.standard_normal((P, page, Hkv, D)).astype(np.float32))
        codes, sc = _quant_rows(x, dt)
        pool = codes.to(dt)
        pools.append(pool)
        values.append(pool.float())
        scales.append(sc.contiguous())
        raw = pool.view(torch.uint8).numpy()
        ref.append(raw.view(jnp.float8_e4m3fn) if kv == "fp8"
                   else pool.numpy())
    args = (q, *pools, torch.from_numpy(bt), torch.from_numpy(seq_lens))
    return args, values, scales, ref


#: (page, Tb, G, D, lanes, Hkv) of the one-byte cases: two of CASES (edge
#: lanes) and one lane of G = 3 over a 768-key table (three splits), whose
#: partials' count is odd
QUANT_CASES = [(16, 40, 3, 64, None, HKV), (8, 80, 3, 128, None, HKV),
               (16, 48, 3, 128, [700], 1)]


@pytest.mark.parametrize("kv", sorted(KV_DTYPES))
@pytest.mark.parametrize("page,Tb,G,D,lanes,Hkv", QUANT_CASES)
def test_one_byte_split_items_match_pallas_and_oracle(kv, page, Tb, G, D,
                                                      lanes, Hkv):
    args, (kf, vf), (ks, vs), (kr, vr) = _quant_case(
        kv, page, Tb, G, D, seed=page * G + D, lens=lanes, Hkv=Hkv)
    q, _, _, bt, seq_lens = args
    jq, jbt, jsl = (jnp.asarray(t.numpy()) for t in (q, bt, seq_lens))
    jsc = dict(k_scale=jnp.asarray(ks.numpy()),
               v_scale=jnp.asarray(vs.numpy()))
    jk, jv = jnp.asarray(kr), jnp.asarray(vr)
    pallas = torch.from_numpy(np.array(RPA.paged_decode_attention(
        jq, jk, jv, jbt, jsl, **jsc, interpret=True)))
    oracle = torch.from_numpy(np.array(_REF(jq, jk, jv, jbt, jsl, **jsc)))
    live = seq_lens > 0
    exact, _, n_combined = emulate_decode_splits(
        q, kf, vf, bt, seq_lens, round_bf16=False, k_scale=ks, v_scale=vs)
    assert n_combined == (4 if lanes is None else 1)
    np.testing.assert_allclose(exact.numpy(), pallas.numpy(), atol=TOL_FP32,
                               rtol=0)
    np.testing.assert_allclose(exact[live].numpy(), oracle[live].numpy(),
                               atol=TOL_FP32, rtol=0)
    emu, _, _ = emulate_decode_splits(q, kf, vf, bt, seq_lens, k_scale=ks,
                                      v_scale=vs)
    assert torch.equal(emu[~live], torch.zeros_like(emu[~live]))
    for want in (pallas, oracle):
        err = (emu[live] - want[live]).abs().max().item()
        assert err <= TOL_BF16, err
    # and the port's plain version on the one-byte pools themselves
    plain = PA.paged_decode_attention_plain(q, *args[1:], k_scale=ks,
                                            v_scale=vs)
    np.testing.assert_allclose(exact[live].numpy(), plain[live].numpy(),
                               atol=TOL_FP32, rtol=0)


@pytest.mark.parametrize("max_keys", [64, 96, 256, 512, 640, 1000, 2048,
                                      4096, 32768])
def test_split_ranges_cover_every_key_once(max_keys):
    """Each lane length's items cover keys 0 .. min(len, max_keys) - 1 once,
    in whole 64-key tiles but the last, in at most MAX_SPLITS splits, and
    the grid's n_splits covers the longest lane."""
    L = PA.split_keys(max_keys)
    n_splits = -(-max_keys // L)
    assert 1 <= n_splits <= PA.MAX_SPLITS
    for n in sorted({0, 1, 63, 64, 65, L - 1, L, L + 1, max_keys - 1,
                     max_keys, max_keys + 7}):
        ranges = split_ranges(n, max_keys)
        keys = [k for a, b in ranges for k in range(a, b)]
        assert keys == list(range(max(0, min(n, max_keys))))
        assert len(ranges) <= n_splits
        assert all((b - a) % PA.TILE_KEYS == 0 for a, b in ranges[:-1])


def test_split_rule_mirrors_the_kernel_sources():
    """The decode kernel cuts keys as the packed kernel does: the same
    constants in both headers and in the Python mirror; at 8 lanes x 1021
    keys and 8 KV heads (the serving decode tick) that is 256 live items of
    the fixed (B * Hkv, 8) grid."""
    csrc = pathlib.Path(PA.__file__).parent / "csrc"
    for name in ("paged_decode_splits.cuh", "paged_packed_tc.cuh"):
        const = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                                (csrc / name).read_text()))
        assert int(const["kKeys"]) == PA.TILE_KEYS
        assert int(const["kMinSplit"]) == PA.MIN_SPLIT_KEYS
        assert int(const["kMaxSplits"]) == PA.MAX_SPLITS
    assert PA.split_keys(2048) == 256
    items = sum(len(split_ranges(1021, 2048)) for _ in range(8)) * 8
    assert items == 256 and 8 * 8 * -(-2048 // 256) == 512


def test_emulation_handles_lengths_past_the_table():
    """seq_len beyond Tb * page reads the table's keys only."""
    args = _case(16, 40, 3, 64, seed=5)
    q, kp, vp, bt, seq_lens = (torch.from_numpy(a) for a in args)
    longer = seq_lens.clone()
    longer[6] = 40 * 16 + 100
    a, _, _ = emulate_decode_splits(q, kp, vp, bt, seq_lens)
    b, _, _ = emulate_decode_splits(q, kp, vp, bt, longer)
    assert torch.equal(a, b)
    assert math.isfinite(b.abs().max().item())


@pytest.mark.cuda
def test_one_byte_split_kernel_matches_the_emulation_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for kv, (page, Tb, G, D, lanes, Hkv) in itertools.product(
            sorted(KV_DTYPES), QUANT_CASES):
        args, (kf, vf), (ks, vs), _ = _quant_case(kv, page, Tb, G, D,
                                                  seed=1, lens=lanes, Hkv=Hkv)
        card = [a.cuda() for a in args]
        card[0] = card[0].to(torch.bfloat16)
        sc = dict(k_scale=ks.cuda(), v_scale=vs.cuda())
        out = PA.paged_decode_attention(*card, **sc).float().cpu()
        again = PA.paged_decode_attention(*card, **sc).float().cpu()
        emu, _, _ = emulate_decode_splits(args[0], kf, vf, *args[3:],
                                          k_scale=ks, v_scale=vs)
        assert (out - emu).abs().max().item() <= TOL_BF16
        assert torch.equal(out, again)
        dead = args[4] == 0
        assert torch.equal(out[dead], torch.zeros_like(out[dead]))


@pytest.mark.cuda
def test_split_kernel_matches_the_emulation_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for page, Tb, G, D in CASES:
        args = [torch.from_numpy(a) for a in _case(page, Tb, G, D, seed=1)]
        q, kp, vp, bt, seq_lens = args
        card = [a.cuda() for a in args]
        card[:3] = [a.to(torch.bfloat16) for a in card[:3]]
        out = PA.paged_decode_attention(*card).float().cpu()
        again = PA.paged_decode_attention(*card).float().cpu()
        emu, _, _ = emulate_decode_splits(q, kp, vp, bt, seq_lens)
        # expf and the reciprocal are approximate on the card: a bf16 ulp
        assert (out - emu).abs().max().item() <= TOL_BF16
        assert torch.equal(out, again)
        assert torch.equal(out[-1], torch.zeros_like(out[-1]))
