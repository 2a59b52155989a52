"""Quantized KV pages in the port (``EngineConfig.kv_dtype`` int8 / fp8)
against the JAX package: the row quantizer, the cache layout and its byte
count, the plain scale variants of the three paged-attention kernels against
``ref.py``'s oracles and the Pallas kernels in interpret mode, the padded
ticks (sequential and dual-branch) and the serving engine's greedy streams,
alone and with the prefix cache; and (on a card only) each CUDA scale
variant against its plain version."""
import functools
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.core.plan import ExecutionPlan as RPlan  # noqa: E402
from repro.kernels import paged_attention as RPA  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import scheduler as RS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import fal  # noqa: E402
from repro_torch.core.plan import ExecutionPlan as TPlan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402

KV = ("int8", "fp8")
_JNP = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
_TORCH = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
#: fp32 on both sides, softmax sums in another order
TOL = 1e-4


def _bytes(x):
    """The raw bytes of a torch tensor or a (numpy / JAX) array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


# --------------------------------------------------------------------------- #
# the row quantizer and the cache
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_matches_reference(kv, dtype):
    """The same rows through both ``_quant_rows``: the narrow codes are
    byte-identical (both round half to even, both fp8 casts round to
    nearest even) and the scales agree to fp32 rounding; rows span six
    decades of magnitude, and an all-zero row takes the 1e-8 floor."""
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((7, 5, 4, 32)).astype(np.float32)
    vals *= 10.0 ** rng.uniform(-3, 3, (7, 5, 1, 1)).astype(np.float32)
    vals[3, 2] = 0.0
    jv = jnp.asarray(vals).astype(dtype)
    tv = torch.from_numpy(vals).to(getattr(torch, dtype))
    rq, rs = RA._quant_rows(jv, _JNP[kv])
    tq, ts = TA._quant_rows(tv, _TORCH[kv])
    np.testing.assert_array_equal(_bytes(tq.to(_TORCH[kv])),
                                  _bytes(rq.astype(_JNP[kv])))
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=1e-6)
    assert float(ts[3, 2]) == 1e-8 or abs(float(ts[3, 2]) - 1e-8) < 1e-14


@functools.lru_cache(maxsize=None)
def _models(connection="fal"):
    rcfg = ref_config("llama3.2-3b").reduced().replace(connection=connection)
    tcfg = get_config("llama3.2-3b").reduced().replace(connection=connection)
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


@pytest.mark.parametrize("kv", ("", "bf16") + KV)
def test_init_paged_cache_and_page_bytes_match_reference(kv):
    """Every leaf of the port's cache has the reference's shape and dtype,
    and the engine's bytes per page (every pool leaf, scales included,
    ``a1_sig`` excluded) equal the reference engine's."""
    rcfg, rparams, tcfg, tparams = _models()
    ref = RM.init_paged_cache(rcfg, 8, 4, 2, "float32", kv_dtype=kv)
    got = TM.init_paged_cache(tcfg, 8, 4, 2, "float32", kv_dtype=kv,
                              device="cpu")
    names = {"bfloat16": "bfloat16", "float8_e4m3fn": "float8_e4m3fn"}
    for part in ("block0", "blocks"):
        assert set(got[part]) == set(ref[part])
        for name, leaf in ref[part].items():
            t = got[part][name]
            assert tuple(t.shape) == leaf.shape, (part, name)
            assert str(t.dtype)[6:] == names.get(leaf.dtype.name,
                                                 leaf.dtype.name)
            np.testing.assert_array_equal(_bytes(t), _bytes(leaf))
    ecfg = dict(page_size=8, num_pages=16, kv_dtype=kv)
    r = RS.PagedEngine(rcfg, rparams, RS.EngineConfig(**ecfg))
    t = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**ecfg), device="cpu")
    assert t.stats()["pages"]["page_bytes"] == \
        r.stats()["pages"]["page_bytes"] > 0


# --------------------------------------------------------------------------- #
# the scale variants' plain versions
# --------------------------------------------------------------------------- #
def _pools(rng, kv, P, page, Hkv, D):
    """Quantized K/V pools with their (P, page) scales, as numpy (the
    reference's dtypes) and as the port's tensors (the same bytes)."""
    if kv == "int8":
        k = rng.integers(-127, 128, (P, page, Hkv, D)).astype(np.int8)
        v = rng.integers(-127, 128, (P, page, Hkv, D)).astype(np.int8)
    else:
        k = np.asarray(jnp.asarray(rng.standard_normal(
            (P, page, Hkv, D)) * 100).astype(jnp.float8_e4m3fn))
        v = np.asarray(jnp.asarray(rng.standard_normal(
            (P, page, Hkv, D)) * 100).astype(jnp.float8_e4m3fn))
    ks = rng.uniform(0.002, 0.03, (P, page)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, (P, page)).astype(np.float32)
    ref = dict(k=k, v=v, k_scale=ks, v_scale=vs)
    return ref, interop.cache_from_numpy(ref, "cpu")


def _tables(rng, P, B, Tb):
    bt = np.zeros((B, Tb), np.int32)
    bt[:, :Tb - 1] = rng.permutation(np.arange(1, P))[:B * (Tb - 1)] \
        .reshape(B, Tb - 1)
    return bt


def _case(kernel, kv, page, D, G, Hkv=2, seed=0):
    """(reference args, port args) of one call, scales as keywords: ragged
    packed segments with padding, decode lanes of lengths 1 .. the full
    table, chunk lanes with n_valid 0 .. C at pos 0 and > 0."""
    rng = np.random.default_rng(seed)
    P, H, Tb = 48, G * Hkv, 24 // page + 2
    pools, tpools = _pools(rng, kv, P, page, Hkv, D)
    if kernel == "paged_packed_attention":
        bt = _tables(rng, P, 4, Tb)
        tok_slot = np.array([0] * 5 + [1] * 3 + [2, 3] + [0] * 3, np.int32)
        tok_pos = np.array(list(range(5)) + [9, 10, 11, 17, 6] + [-1] * 3,
                           np.int32)
        q = rng.standard_normal((len(tok_slot), H, D)).astype(np.float32)
        idx = [bt, tok_slot, tok_pos]
    elif kernel == "paged_decode_attention":
        bt = _tables(rng, P, 4, Tb)
        q = rng.standard_normal((4, H, D)).astype(np.float32)
        idx = [bt, np.array([1, page, Tb * page, 2 * page + 3], np.int32)]
    else:
        lanes = [(0, 5), (0, 0), (7, 1), (9, 3), (5, 0), (12, 5)]
        bt = _tables(rng, P, len(lanes), (12 + 5) // page + 1)
        q = rng.standard_normal((len(lanes), 5, H, D)).astype(np.float32)
        idx = [bt, np.array([p for p, _ in lanes], np.int32),
               np.array([n for _, n in lanes], np.int32)]
    ref_args = [q, pools["k"], pools["v"]] + idx
    port_args = [torch.from_numpy(q), tpools["k"], tpools["v"]] + \
        [torch.from_numpy(a) for a in idx]
    return (ref_args, dict(k_scale=pools["k_scale"], v_scale=pools["v_scale"]),
            port_args, dict(k_scale=tpools["k_scale"],
                            v_scale=tpools["v_scale"]))


_ORACLES = {"paged_packed_attention": RREF.paged_packed_attention_ref,
            "paged_decode_attention": RREF.paged_attention_ref,
            "paged_chunk_attention": RREF.paged_chunk_attention_ref}


@pytest.mark.parametrize("kernel", sorted(_ORACLES))
@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("page,D,G", [(4, 32, 1), (8, 64, 3), (8, 32, 4),
                                      (4, 64, 2)])
def test_scale_plain_matches_oracle_and_pallas_interpret(kernel, kv, page,
                                                         D, G):
    ref_args, ref_kw, port_args, port_kw = _case(kernel, kv, page, D, G,
                                                 seed=page * D + G)
    jargs = [jnp.asarray(a) for a in ref_args]
    jkw = {k: jnp.asarray(v) for k, v in ref_kw.items()}
    want = np.asarray(_ORACLES[kernel](*jargs, **jkw))
    pallas = np.asarray(getattr(RPA, kernel)(*jargs, **jkw, interpret=True))
    ops.reset_dispatch_paths()
    got = getattr(ops, kernel)(*port_args, **port_kw).numpy()
    assert ops.dispatch_paths() == {f"{kernel}.{kv}": ops.PLAIN}
    rows = slice(None)
    if kernel == "paged_packed_attention":
        rows = ref_args[-1] >= 0                   # padding rows are 0
        assert np.all(got[~rows] == 0.0) and np.all(pallas[~rows] == 0.0)
    np.testing.assert_allclose(got[rows], want[rows], atol=TOL, rtol=0)
    np.testing.assert_allclose(got[rows], pallas[rows], atol=TOL, rtol=0)


# --------------------------------------------------------------------------- #
# the padded ticks and the engine
# --------------------------------------------------------------------------- #
def _padded_run(mod_step, params, cfg, cache, plan, tokens, lens, bt,
                n_decode, asarray):
    """One C = 8 chunk tick over the prompts, then ``n_decode`` greedy
    C == 1 ticks; returns (per-tick logits as numpy, the cache)."""
    B, C = tokens.shape
    out = []
    batch = dict(tokens=asarray(tokens), pos=asarray(np.zeros(B, np.int32)),
                 n_valid=asarray(lens), block_tables=asarray(bt))
    logits, cache = mod_step(params, cfg, batch, cache, plan)
    logits = np.asarray(logits, np.float32)
    nxt = logits[np.arange(B), lens - 1].argmax(-1).astype(np.int32)
    out.append(logits[np.arange(B), lens - 1])
    for i in range(n_decode):
        batch = dict(tokens=asarray(nxt[:, None]), pos=asarray(lens + i),
                     n_valid=asarray(np.ones(B, np.int32)),
                     block_tables=asarray(bt))
        logits, cache = mod_step(params, cfg, batch, cache, plan)
        logits = np.asarray(logits, np.float32)[:, 0]
        nxt = logits.argmax(-1).astype(np.int32)
        out.append(logits)
    return out, cache


_REF_STEP = jax.jit(RM.paged_decode_step, static_argnums=(1, 4))


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("dual", [False, True])
def test_padded_ticks_match_reference(kv, dual):
    """A chunk tick and three decode ticks of the padded layout on
    quantized pages, sequentially and under a dual-branch plan (whose C ==
    1 ticks take the reference's two-op route: the decode kernel's scale
    variant and ``mlp_apply``, nothing fused): logits and greedy tokens
    equal the reference's, and the quantized pools hold the same codes."""
    rcfg, rparams, tcfg, tparams = _models()
    rng = np.random.default_rng(5)
    lens = np.array([8, 5, 7], np.int32)
    tokens = rng.integers(0, rcfg.vocab, (3, 8)).astype(np.int32)
    bt = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
    rcache = RM.init_paged_cache(rcfg, 16, 4, 3, "float32", kv_dtype=kv)
    tcache = interop.cache_from_numpy(jax.tree.map(np.asarray, rcache), "cpu")
    rplan = RPlan.single_device("paged", dual_branch=dual)
    tplan = TPlan.single_device("paged", dual_branch=dual)
    want, rcache = _padded_run(_REF_STEP, rparams, rcfg, rcache, rplan,
                               tokens, lens, bt, 3, jnp.asarray)
    ops.reset_dispatch_paths()
    with torch.no_grad():
        got, tcache = _padded_run(TM.paged_decode_step, tparams, tcfg,
                                  tcache, tplan, tokens, lens, bt, 3,
                                  torch.from_numpy)
    paths = ops.dispatch_paths()
    assert paths == {f"paged_chunk_attention.{kv}": ops.PLAIN,
                     f"paged_decode_attention.{kv}": ops.PLAIN,
                     "fused_ln_add": ops.PLAIN}
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    for part in ("block0", "blocks"):
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                _bytes(tcache[part][name]),
                _bytes(np.asarray(rcache[part][name])))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tcache[part][name].numpy(),
                                       np.asarray(rcache[part][name]),
                                       rtol=1e-5)


def _serve(engine, mod, prompts, max_new):
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        engine.submit(mod.ServeRequest(rid=i, prompt=p, max_new=n))
    return {r.rid: list(map(int, r.generated)) for r in engine.run()}


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("dual", [False, True])
def test_quantized_engine_streams_match_reference(kv, dual):
    """The packed engine on int8 / fp8 pages, with and without
    dual_branch: greedy streams, tick and token counts equal the
    reference's; the ticks ran the ``.int8`` / ``.fp8`` site only."""
    rcfg, rparams, tcfg, tparams = _models()
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, 512, 4 + i % 7) for i in range(6)]
    max_new = [8 + 3 * (i % 3) for i in range(6)]
    kw = dict(page_size=8, num_pages=48, slots=4, prefill_chunk=8,
              max_seq=128, kv_dtype=kv, dual_branch=dual)
    ref = RS.PagedEngine(rcfg, rparams, RS.EngineConfig(**kw))
    want = _serve(ref, RS, prompts, max_new)
    ops.reset_dispatch_paths()
    port = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**kw), device="cpu")
    assert _serve(port, TS, prompts, max_new) == want
    assert ops.dispatch_paths() == {f"paged_packed_attention.{kv}": ops.PLAIN,
                                    "fused_ln_add": ops.PLAIN}
    rs, ts = ref.stats(), port.stats()
    for key in ("ticks", "prefill_tokens", "decode_tokens", "preemptions"):
        assert ts[key] == rs[key], key
    assert ts["pages"]["page_bytes"] == rs["pages"]["page_bytes"]


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("connection", ["fal", "preln"])
def test_quantized_prefix_hit_matches_cold_and_reference(kv, connection):
    """Prefix cache over quantized pages: a probe that hits a donor's
    parked prefix emits the tokens of a cold engine's probe and of the
    reference's hot engine, with the same prefix stats; the row scales ride
    the COW copy (``copy_pages`` ran)."""
    rcfg, rparams, tcfg, tparams = _models(connection)
    sysp = np.random.default_rng(3).integers(1, rcfg.vocab, 16)
    tail = np.random.default_rng(5).integers(1, rcfg.vocab, 5)
    kw = dict(page_size=8, num_pages=48, slots=2, prefill_chunk=8,
              max_seq=64, cache_dtype="float32", prefix_cache=True,
              kv_dtype=kv)

    def hot(mod, eng):
        eng.submit(mod.ServeRequest(rid=1, prompt=sysp, max_new=4))
        eng.run()
        eng.reset_stats()
        probes = [mod.ServeRequest(rid=2, prompt=np.concatenate([sysp, tail]),
                                   max_new=5),
                  mod.ServeRequest(rid=3, prompt=sysp.copy(), max_new=5)]
        for p in probes:
            eng.submit(p)
        eng.run()
        return [p.generated for p in probes], eng.stats()["prefix"]

    want, rstats = hot(RS, RS.PagedEngine(rcfg, rparams,
                                          RS.EngineConfig(**kw)))
    ops.reset_dispatch_paths()
    eng = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**kw), device="cpu")
    got, tstats = hot(TS, eng)
    assert got == want
    want_paths = {f"paged_packed_attention.{kv}": ops.PLAIN,
                  "copy_pages": ops.PLAIN}
    if connection in fal.FUSED_LN_ADD_MODES:
        want_paths["fused_ln_add"] = ops.PLAIN
    assert ops.dispatch_paths() == want_paths
    assert tstats["cow_copies"] == rstats["cow_copies"] == 1
    for key in ("hits", "misses", "hit_rate", "cached_pages",
                "a1_sig_seeded", "inserted_pages"):
        assert tstats[key] == rstats[key], key
    cold = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**kw), device="cpu")
    assert _serve(cold, TS, [np.concatenate([sysp, tail]), sysp.copy()],
                  [5, 5]) == {0: got[0], 1: got[1]}
    eng.pcache.clear()
    assert eng.allocator.in_use == 0


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
def test_scale_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for kernel, kv, (page, D, G), dtype in itertools.product(
            sorted(_ORACLES), KV, ((4, 32, 1), (8, 64, 3), (16, 128, 3)),
            (torch.float32, torch.bfloat16)):
        _, _, args, kw = _case(kernel, kv, page, D, G)
        args = [a.cuda() for a in args]
        kw = {k: v.cuda() for k, v in kw.items()}
        q = args[0].to(dtype)
        out = getattr(PA, kernel + "_cuda")(q, *args[1:], **kw)
        ref = getattr(PA, kernel + "_plain")(q.float(), *args[1:], **kw)
        torch.cuda.synchronize()
        # fp32: sums in another order; bf16: one output rounding
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = (out.float() - ref.to(dtype).float()).abs().max().item()
        assert err <= tol, (kernel, kv, page, D, G, dtype, err)
