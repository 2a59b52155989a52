"""The port's seeded sampler against the JAX package's: threefry bits bit for
bit against ``jax.random``, the top-k / top-p masks (tie order included),
the full and fast samplers over a grid of (params, seed, position), and the
engine's seeded token streams (plain, through preemption and through a
prefix-cache hit) against the JAX engine's on the reduced llama3.2-3b."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import sampling as RSP  # noqa: E402
from repro.serve import scheduler as RS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import prng  # noqa: E402
from repro_torch.serve import sampling as TSP  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402

SEEDS = (0, 1, 2 ** 31 - 1, -123457)
SHAPES = (1, 7, 512, 128256)


def _u32(a):
    return np.asarray(a).astype(np.int64)


def test_threefry_partitionable_is_on():
    """The port mirrors the partitionable threefry bits; the reference
    draws them only while this flag holds."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    pos = np.arange(301, dtype=np.int32)
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        prng.prng_key(torch.tensor([seed], dtype=torch.int32))[0].numpy(),
        _u32(key))
    ref = _u32(jax.vmap(lambda p: jax.random.fold_in(key, p))(pos))
    got = prng.fold_in(prng.prng_key(torch.full((301,), seed,
                                                dtype=torch.int32)),
                       torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n", SHAPES)
def test_bits_and_uniform_match_jax(n):
    """32-bit random bits and ``uniform(minval=1e-20)`` bit for bit, for
    every seed at positions 0, 1 and 300 in one batched call."""
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(s), p))
                     for s in SEEDS for p in (0, 1, 300)])
    tkeys = torch.from_numpy(_u32(keys))
    bits = prng.random_bits(tkeys, n).numpy()
    uni = prng.uniform(tkeys, n, 1e-20, 1.0).numpy()
    for i, k in enumerate(keys):
        k = jnp.asarray(k)
        np.testing.assert_array_equal(bits[i], _u32(jax.random.bits(k, (n,))))
        ref = np.asarray(jax.random.uniform(k, (n,), minval=1e-20,
                                            maxval=1.0))
        np.testing.assert_array_equal(uni[i].view(np.int32),
                                      ref.view(np.int32))


def test_gumbel_noise_within_tolerance():
    """-log(-log(u)) on the same u: torch's log and XLA's differ in the last
    bit, so the noise agrees within 1e-6 + 1e-6 |g| (each of the two logs
    within an ulp, the inner one's error divided by its value)."""
    seeds = np.asarray(SEEDS, np.int32)
    pos = np.asarray([0, 5, 77, 300], np.int32)
    V = 128256
    ref = np.stack([np.asarray(-jnp.log(-jnp.log(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(int(s)), int(p)), (V,),
        minval=1e-20, maxval=1.0)))) for s, p in zip(seeds, pos)])
    got = TSP.gumbel(torch.from_numpy(seeds), torch.from_numpy(pos), V,
                     "cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_cumsum_follows_xla_order():
    """The port's cumsum is the reference's ``jnp.cumsum`` bit for bit (the
    prefix mass of the top-p mask), at the lengths the samplers use and at
    the edges of its rows of 16."""
    rng = np.random.default_rng(0)
    for n in (1, 15, 16, 17, 33, 64, 255, 256, 257, 512, 4097, 128256):
        x = (rng.random((3, n)) / n).astype(np.float32)
        ref = np.asarray(jax.jit(jax.vmap(jnp.cumsum))(x))
        got = TSP.cumsum(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


# --------------------------------------------------------------------------- #
# masks
# --------------------------------------------------------------------------- #
def _ref_mask(fn, logits, arg):
    return np.isfinite(np.asarray(jax.vmap(fn)(jnp.asarray(logits),
                                               jnp.asarray(arg))))


def _port_mask(fn, logits, arg):
    return np.isfinite(fn(torch.from_numpy(logits),
                          torch.from_numpy(arg)).numpy())


def _tie_fixtures(seed, values, n=25):
    """The reference's tie fixtures (``tests/test_serving.py:540-590``):
    25 rows of 2..39 values drawn from a few levels, padded with -inf to one
    width (a -inf column is kept only by a mask that keeps everything)."""
    rng = np.random.default_rng(seed)
    rows = [rng.choice(values, size=int(rng.integers(2, 40)))
            for _ in range(n)]
    out = np.full((n, 40), -np.inf, np.float32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, [len(r) for r in rows], rng


def test_mask_top_k_ties_match_reference():
    fixed = np.asarray([[1.0, 2.0, 2.0, 2.0, 0.5, 2.0]], np.float32)
    kept = _port_mask(TSP.mask_top_k, fixed, np.asarray([2], np.int32))
    assert list(np.nonzero(kept[0])[0]) == [1, 2]       # lower index first
    logits, lens, rng = _tie_fixtures(0, [-1.0, 0.0, 0.25, 1.0, 3.0])
    k = np.asarray([rng.integers(1, n + 1) for n in lens], np.int32)
    for kk in (k, np.zeros_like(k), np.full_like(k, 100)):
        np.testing.assert_array_equal(_port_mask(TSP.mask_top_k, logits, kk),
                                      _ref_mask(RSP._mask_top_k, logits, kk))


def test_mask_top_p_ties_match_reference():
    four = np.zeros((3, 4), np.float32)
    assert _port_mask(TSP.mask_top_p, four, np.asarray(
        [0.5, 0.0, 1.0], np.float32)).sum(-1).tolist() == [2, 1, 4]
    logits, lens, rng = _tie_fixtures(1, [0.0, 0.0, 1.0, 2.0])
    p = rng.choice([0.0, 0.3, 0.5, 0.9, 0.999, 1.0],
                   size=len(lens)).astype(np.float32)
    np.testing.assert_array_equal(_port_mask(TSP.mask_top_p, logits, p),
                                  _ref_mask(RSP._mask_top_p, logits, p))


def test_masks_match_reference_on_random_logits():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((32, 512)) * 2).astype(np.float32)
    k = rng.integers(0, 600, 32).astype(np.int32)
    p = rng.choice([0.0, 0.3, 0.5, 0.9, 0.95, 0.999, 1.0],
                   size=32).astype(np.float32)
    np.testing.assert_array_equal(_port_mask(TSP.mask_top_k, logits, k),
                                  _ref_mask(RSP._mask_top_k, logits, k))
    np.testing.assert_array_equal(_port_mask(TSP.mask_top_p, logits, p),
                                  _ref_mask(RSP._mask_top_p, logits, p))


def test_top_p_boundary_divergence_at_full_vocab():
    """The accepted divergence (ROADMAP Queue 3): over 128256 tokens the
    softmax's exp and total are torch's, so the tokens whose exclusive
    prefix mass lies within rounding of p can be kept by one side and
    dropped by the other (in this data: two tail tokens of one p = 0.999
    lane, whose increments are below the sum's ulp).  Every difference lies
    within 1e-5 of p in exact arithmetic (a fp32 sum of 128256 terms in
    rows of 16 over four levels errs by at most 64 ulps of 1, 4e-6, plus
    the exp and total's rounding), and the sampled tokens are the
    reference's."""
    rng = np.random.default_rng(4)
    B, V = 8, 128256
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    p = np.asarray([0.999, 0.999, 0.95, 0.9] * 2, np.float32)
    got = _port_mask(TSP.mask_top_p, logits, p)
    ref = _ref_mask(RSP._mask_top_p, logits, p)
    x = logits.astype(np.float64)
    probs = np.exp(x - x.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    for b in range(B):
        order = np.argsort(-probs[b], kind="stable")
        excl = np.empty(V)
        excl[order] = np.cumsum(probs[b, order]) - probs[b, order]
        diff = np.nonzero(got[b] != ref[b])[0]
        assert np.abs(excl[diff] - p[b]).max(initial=0.0) < 1e-5, (b, diff)
    args = (logits, np.full(B, 0.9, np.float32), np.zeros(B, np.int32), p,
            np.arange(B, dtype=np.int32), np.arange(B, dtype=np.int32) * 40)
    ref_tok = np.asarray(RSP.sample_tokens(*map(jnp.asarray, args)))
    got_tok = TSP.sample_tokens(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got_tok, ref_tok)


# --------------------------------------------------------------------------- #
# samplers
# --------------------------------------------------------------------------- #
def _grid(B, V, seed):
    """(params, seed, position) lanes: greedy, temperature only, small and
    capped top_k with and without top_p, top_p only, top_k past the cap, and
    degenerate p = 0 / k = 1; seeds include a negative int32."""
    rng = np.random.default_rng(seed)
    params = [(0.0, 0, 1.0), (0.9, 0, 1.0), (0.9, 50, 0.95), (1.3, 64, 1.0),
              (0.5, 0, 0.9), (0.7, 1, 1.0), (1.0, 10, 0.0), (0.8, 200, 0.5),
              (2.0, 0, 0.999), (0.9, 50, 1.0)]
    rows = [params[i % len(params)] for i in range(B)]
    temps = np.asarray([r[0] for r in rows], np.float32)
    ks = np.asarray([r[1] for r in rows], np.int32)
    ps = np.asarray([r[2] for r in rows], np.float32)
    seeds = rng.choice(np.asarray(SEEDS, np.int32), B).astype(np.int32)
    pos = rng.integers(0, 300, B).astype(np.int32)
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    return logits, temps, ks, ps, seeds, pos


@pytest.mark.parametrize("V,B,seed", [(512, 20, 0), (512, 20, 1),
                                      (128256, 10, 2)])
def test_samplers_match_reference(V, B, seed):
    args = _grid(B, V, seed)
    j, t = tuple(map(jnp.asarray, args)), tuple(map(torch.from_numpy, args))
    full = TSP.sample_tokens(*t).numpy()
    np.testing.assert_array_equal(full, np.asarray(RSP.sample_tokens(*j)))
    fast = TSP.fast_sampler(V)(*t).numpy()
    np.testing.assert_array_equal(
        fast, np.asarray(jax.jit(jax.vmap(RSP.fast_sampler(V)))(*j)))
    eligible = np.asarray([TSP.fast_eligible(TSP.SamplingParams(
        float(a), int(b), float(c)), V) for a, b, c in zip(*args[1:4])])
    assert eligible.sum() >= B // 2 and not eligible.all()
    np.testing.assert_array_equal(fast[eligible], full[eligible])
    greedy = TSP.greedy_sampler(*t).numpy()
    np.testing.assert_array_equal(greedy[args[1] <= 0], full[args[1] <= 0])


def test_fast_sampler_tie_order():
    """On tied logits the fast sampler's candidates are ``lax.top_k``'s:
    the tied tokens with the lower indices, in index order."""
    logits = np.zeros((2, 300), np.float32)
    logits[0, [5, 17, 200, 201, 299]] = 1.0
    logits[1, ::3] = 2.0
    idx = torch.topk(TSP.order_keys(torch.from_numpy(logits)), 64).indices
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(logits), 64)[1]))
    args = (logits, np.full(2, 1.0, np.float32), np.full(2, 3, np.int32),
            np.ones(2, np.float32), np.asarray([4, 9], np.int32),
            np.asarray([0, 1], np.int32))
    for s in range(8):
        a = args[:4] + (args[4] + s,) + args[5:]
        got = TSP.fast_sampler(300)(*map(torch.from_numpy, a)).numpy()
        assert got[0] in (5, 17, 200) and got[1] in (0, 3, 6)
        np.testing.assert_array_equal(got, np.asarray(
            RSP.sample_tokens(*map(jnp.asarray, a))))


@pytest.mark.cuda
def test_sampler_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    args = tuple(map(torch.from_numpy, _grid(32, 128256, 4)))
    keys = prng.fold_in(prng.prng_key(args[4]), args[5])
    assert torch.equal(prng.uniform(keys.cuda(), 128256, 1e-20).cpu(),
                       prng.uniform(keys, 128256, 1e-20))
    cuda = tuple(a.cuda() for a in args)
    for fn in (TSP.sample_tokens, TSP.fast_sampler(128256)):
        assert torch.equal(fn(*cuda).cpu(), fn(*args))


# --------------------------------------------------------------------------- #
# the engine's seeded streams
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _models():
    rcfg = ref_config("llama3.2-3b").reduced()
    tcfg = get_config("llama3.2-3b").reduced()
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def _seeded(mod, sp_mod, prompts, max_new):
    """Seeded requests (temperature 0.9, top_p 0.95, seed rid - 3: three
    negative seeds); lanes 0 and 1 take top_k 0 and 100, past the fast cap,
    so ticks with them run the full-sort sampler, the others top_k 50."""
    return [mod.ServeRequest(rid=i, prompt=p, max_new=n,
                             sampling=sp_mod.SamplingParams(
                                 temperature=0.9,
                                 top_k=(0, 100, 50)[min(i, 2)],
                                 top_p=0.95, seed=i - 3))
            for i, (p, n) in enumerate(zip(prompts, max_new))]


def _drive(engine, reqs, waves):
    for wave in waves:
        for i in wave:
            engine.submit(reqs[i])
        engine.run()
    return {r.rid: list(map(int, r.generated)) for r in engine.finished}


def _streams(ecfg_kw, prompts, max_new, waves):
    """Both engines over the same seeded requests, submitted in ``waves``
    (each wave served to the end before the next): the streams must be
    equal."""
    rcfg, rparams, tcfg, tparams = _models()
    ref = RS.PagedEngine(rcfg, rparams, RS.EngineConfig(**ecfg_kw))
    port = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**ecfg_kw),
                          device="cpu")
    ops.reset_dispatch_paths()
    got = _drive(port, _seeded(TS, TSP, prompts, max_new), waves)
    assert got == _drive(ref, _seeded(RS, RSP, prompts, max_new), waves)
    assert ops.dispatch_paths() == {"paged_packed_attention": ops.PLAIN,
                                    "fused_ln_add": ops.PLAIN}
    return port, ref


def test_engine_seeded_streams_match_reference():
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, 512, 4 + i % 7) for i in range(6)]
    port, ref = _streams(dict(page_size=8, num_pages=48, slots=4,
                              prefill_chunk=8, max_seq=128),
                         prompts, [8 + 3 * (i % 3) for i in range(6)],
                         [range(6)])
    assert port.stats()["ticks"] == ref.stats()["ticks"]


def test_engine_seeded_preemption_matches_reference():
    """A page-starved engine preempts and re-prefills; the resumed lanes
    draw at the same (seed, position) keys, so the streams still equal the
    JAX engine's."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, int(n)) for n in rng.integers(16, 24, 8)]
    port, _ = _streams(dict(page_size=4, num_pages=13, slots=3,
                            prefill_chunk=8, max_seq=64),
                       prompts, [6] * 8, [range(8)])
    assert port.stats()["preemptions"] > 0


def test_engine_seeded_prefix_hit_matches_reference():
    """A donor parks its prefix; a verbatim repeat (same seed) then hits it
    and enters decode on its first tick with the same stream."""
    rng = np.random.default_rng(5)
    p = rng.integers(0, 512, 17)
    port, ref = _streams(dict(page_size=8, num_pages=48, slots=2,
                              prefill_chunk=8, max_seq=64,
                              prefix_cache=True),
                         [p, p, p], [8, 8, 8], [[2], [0, 1]])
    ticks_only = [{k: v for k, v in e.stats()["prefix"].items()
                   if not k.endswith("_ms")} for e in (port, ref)]
    assert ticks_only[0]["hits"] >= 2 and ticks_only[0] == ticks_only[1]


def test_engine_sampling_reproducible():
    """Twin of ``tests/test_serving.py:136``: same seed, same stream; another
    seed, another stream."""
    _, _, tcfg, tparams = _models()

    def run_once(seed):
        eng = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(
            page_size=8, num_pages=48, slots=2, prefill_chunk=8, max_seq=64),
            device="cpu")
        eng.submit(TS.ServeRequest(
            rid=0, prompt=np.arange(6) % tcfg.vocab, max_new=10,
            sampling=TSP.SamplingParams(temperature=0.8, top_k=50,
                                        top_p=0.95, seed=seed)))
        return eng.run()[0].generated

    a, b, c = run_once(7), run_once(7), run_once(8)
    assert a == b
    assert a != c
