"""gemma2 in the port against the JAX package on the CPU, at the reduced
config (d 128, 2 layers, 4 / 2 heads of 32, window 64, attention softcap 50,
final softcap 30, post-norms, embed scale, geglu, fal; fp32): the window
schedule; the full-sequence forward, loss and every gradient leaf, with
sequences past the window; the packed tick and the padded ticks (C > 1 and
C == 1) on bf16 and int8 pages with lanes past the window; the greedy
engine's streams with prompts longer than the window; and the
self-speculative engine against the plain one.

Tolerances: logits and loss 1e-4 (fp32 on both sides, two blocks of sums in
another order; the embedding is scaled by sqrt(128), so the residual
stream is of order 10 and the softcapped logits of order 10); gradients
1e-6 plus 1e-4 of each leaf's largest value (``test_torch_train.py``'s
rule).  Ticks: int8 pages in fp32 throughout (dequantized), 1e-4; bf16 pages
round P.V's output to bf16 on both sides from fp32 sums taken in another
order, so an output can land one bf16 ulp (2^-8 relative) apart: hidden
states within 2e-2 of the reference, greedy tokens equal."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import blocks as RB  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import scheduler as RS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402

ARCH = "gemma2-27b"
TOL = 1e-4
#: hidden states on bf16 pages (see the module docstring)
TOL_BF16_PAGES = 2e-2
_REF_STEP = jax.jit(RM.paged_decode_step, static_argnums=(1, 4, 5))


@pytest.fixture(scope="module")
def models():
    rcfg, tcfg = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(6), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu", dtype="float32")
    return rcfg, rparams, tcfg, tparams


def test_window_schedule_matches_reference():
    """Even layers local (the window), odd layers global (0) under
    local_global; every layer the config's window otherwise."""
    for arch, n in (("gemma2-27b", None), ("gemma2-27b", 5),
                    ("llama3.2-3b", None), ("qwen3-4b", 3)):
        for reduce in (False, True):
            rc, tc = ref_config(arch), get_config(arch)
            if reduce:
                rc, tc = rc.reduced(), tc.reduced()
            assert TB.window_schedule(tc, n) == RB.window_schedule(rc, n)
    tcfg = get_config(ARCH).reduced()
    assert TB.window_schedule(tcfg) == [64, 0]
    TM.check_supported(tcfg)                       # gemma2 is served


def test_forward_loss_and_gradients_match_reference(models):
    """S = 100 > the window of 64 (block 0 local, block 1 global): logits,
    loss and every gradient leaf against the reference's forward, loss_fn
    and jax.grad; the attention runs the dispatcher with the window and
    the softcap (the plain versions on the CPU)."""
    from test_torch_train import _close_tree
    rcfg, rparams, tcfg, tparams = models
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (2, 100)) \
        .astype(np.int32)
    r_logits, _, _ = RM.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)})
    r_loss, _ = RM.loss_fn(rparams, rcfg, {"tokens": jnp.asarray(toks)})
    grads = jax.jit(jax.grad(lambda p, b: RM.loss_fn(p, rcfg, b)[0]))(
        rparams, {"tokens": jnp.asarray(toks)})
    ops.reset_dispatch_paths()
    with torch.no_grad():
        t_logits, _, _ = TM.forward(tparams, tcfg,
                                    {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               atol=TOL, rtol=0)
    assert float(np.abs(np.asarray(r_logits)).max()) <= 30.0   # final cap
    params = TO.map_tree(lambda t: t.detach().clone().requires_grad_(True),
                         tparams)
    loss, _ = TM.loss_fn(params, tcfg, {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss.detach()) - float(r_loss)) <= TOL
    loss.backward()
    _close_tree(jax.tree.map(np.asarray, grads),
                TO.map_tree(lambda p: p.grad, params), tcfg, 1e-6, 1e-4)
    assert ops.dispatch_paths() == {"flash_attention": ops.PLAIN,
                                    "fused_ln_add": ops.PLAIN}


def _history(rng, cache):
    """Fill a reference cache (numpy leaves) with a random history: N(0, 1)
    K/V (int8 pages: random codes and row scales) and a1_sig."""
    def fill(name, a):
        a = np.asarray(a)
        if name.endswith("_scale"):
            return rng.uniform(0.005, 0.02, a.shape).astype(np.float32)
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        return rng.standard_normal(a.shape).astype(a.dtype)
    out = {part: {k: fill(k, v) for k, v in cache[part].items()}
           for part in ("block0", "blocks")}
    out["a1_sig"] = rng.standard_normal(np.shape(cache["a1_sig"])).astype(
        np.float32)
    return out


def _caches(rcfg, kv, P, page, slots, seed):
    rc = jax.tree.map(np.asarray, RM.init_paged_cache(
        rcfg, P, page, slots, "float32", kv_dtype=kv))
    rc = _history(np.random.default_rng(seed), rc)
    return (jax.tree.map(jnp.asarray, rc),
            interop.cache_from_numpy(rc, "cpu"))


def _compare_pools(r_c, t_c, kv):
    """The written pools against the reference's.  int8: each side
    quantizes its own fp32 projections, so a value within rounding of a
    boundary can take the neighbouring code: codes at most one apart, in at
    most 0.1% of the elements; row scales within fp32 rounding.  bf16: the
    layers after block 0 project inputs that carry block 0's bf16-rounded
    P.V output (up to ~1e-3 apart, see the module docstring), then round
    to bf16: within one bf16 ulp (<= 2^-7 relative) plus 2e-3."""
    for part in ("block0", "blocks"):
        for name in ("k", "v"):
            # page 0 is scratch: padding rows land there in any order
            a = np.asarray(r_c[part][name], np.float32)[..., 1:, :, :, :]
            b = t_c[part][name].float().numpy()[..., 1:, :, :, :]
            if kv == "int8":
                assert np.abs(b - a).max() <= 1, (part, name)
                assert (b != a).mean() <= 1e-3, (part, name)
            else:
                np.testing.assert_allclose(b, a, rtol=2.0 ** -7, atol=2e-3)
        if kv == "int8":
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(
                    t_c[part][name].numpy()[..., 1:, :],
                    np.asarray(r_c[part][name])[..., 1:, :], rtol=1e-5)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_packed_tick_matches_reference(models, kv):
    """One token-packed tick over a random history: slot 0 prefills 20
    tokens at positions 80..99, slot 1 decodes at 130 and slot 2 at 70 (all
    past the window of 64), three padding tokens: live hidden states,
    a1_sig and the written pools against the reference's."""
    rcfg, rparams, tcfg, tparams = models
    page, Tb, P = 8, 18, 60
    rng = np.random.default_rng(11)
    bt = rng.permutation(np.arange(1, P))[:3 * Tb].reshape(3, Tb) \
        .astype(np.int32)
    tok_slot = np.array([0] * 20 + [1, 2] + [0] * 3, np.int32)
    tok_pos = np.array(list(range(80, 100)) + [130, 70] + [-1] * 3,
                       np.int32)
    batch = dict(tokens=rng.integers(0, rcfg.vocab, tok_slot.shape)
                 .astype(np.int32), tok_slot=tok_slot, tok_pos=tok_pos,
                 block_tables=bt, seg_last=np.array([19, 20, 21], np.int32))
    rc, tc = _caches(rcfg, kv, P, page, 3, seed=12)
    r_h, r_c = _REF_STEP(rparams, rcfg,
                         {k: jnp.asarray(v) for k, v in batch.items()}, rc,
                         None, "hidden")
    ops.reset_dispatch_paths()
    with torch.no_grad():
        t_h, t_c = TM.paged_decode_step(
            tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
            tc, want="hidden")
    live = tok_pos >= 0
    tol = TOL if kv == "int8" else TOL_BF16_PAGES
    np.testing.assert_allclose(t_h[0, live].numpy(),
                               np.asarray(r_h)[0, live], atol=tol, rtol=0)
    np.testing.assert_allclose(t_c["a1_sig"].numpy(),
                               np.asarray(r_c["a1_sig"]), atol=tol, rtol=0)
    _compare_pools(r_c, t_c, kv)
    # every gemma2 layer runs the gather branch (softcap on): no paged
    # attention kernel site, the LN-add kernel for the fal MLP input
    assert ops.dispatch_paths() == {"fused_ln_add": ops.PLAIN}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_padded_ticks_match_reference(models, kv):
    """A padded chunk tick (C = 100 over prompts of 100, 77 and 90 tokens)
    then three greedy C == 1 ticks: logits and greedy tokens against the
    reference's."""
    from test_torch_quantized_kv import _padded_run
    rcfg, rparams, tcfg, tparams = models
    rng = np.random.default_rng(5)
    lens = np.array([100, 77, 90], np.int32)
    tokens = rng.integers(0, rcfg.vocab, (3, 100)).astype(np.int32)
    bt = np.arange(1, 46, dtype=np.int32).reshape(3, 15)
    rcache = RM.init_paged_cache(rcfg, 48, 8, 3, "float32", kv_dtype=kv)
    tcache = interop.cache_from_numpy(jax.tree.map(np.asarray, rcache), "cpu")
    step = jax.jit(RM.paged_decode_step, static_argnums=(1, 4))
    want, rcache = _padded_run(step, rparams, rcfg, rcache, None, tokens,
                               lens, bt, 3, jnp.asarray)
    with torch.no_grad():
        got, tcache = _padded_run(TM.paged_decode_step, tparams, tcfg,
                                  tcache, None, tokens, lens, bt, 3,
                                  torch.from_numpy)
    tol = TOL if kv == "int8" else TOL_BF16_PAGES
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    _compare_pools(rcache, tcache, kv)


def _serve(engine, mod, prompts, max_new):
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        engine.submit(mod.ServeRequest(rid=i, prompt=p, max_new=n))
    return {r.rid: list(map(int, r.generated)) for r in engine.run()}


#: prompts of 70 to 110 tokens: every lane prefills and decodes past the
#: window of 64
_PROMPTS = [np.random.default_rng(9).integers(0, 512, n)
            for n in (70, 110, 85, 96)]
_ECFG = dict(page_size=8, num_pages=72, slots=3, prefill_chunk=32,
             max_seq=160)


def test_engine_streams_match_reference(models):
    """The packed engine, greedy, four requests past the window: the
    reference engine's streams, tick and token counts."""
    rcfg, rparams, tcfg, tparams = models
    max_new = [6, 8, 5, 7]
    ref = RS.PagedEngine(rcfg, rparams, RS.EngineConfig(**_ECFG))
    want = _serve(ref, RS, _PROMPTS, max_new)
    port = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**_ECFG),
                          device="cpu")
    assert _serve(port, TS, _PROMPTS, max_new) == want
    rs, ts = ref.stats(), port.stats()
    for key in ("ticks", "prefill_tokens", "decode_tokens"):
        assert ts[key] == rs[key], key


def test_spec_engine_matches_plain_engine(models):
    """Self-speculative decoding (spec_tokens 3, draft_blocks 1: the draft
    is block 0, the local layer) gives the plain engine's greedy streams."""
    _, _, tcfg, tparams = models
    max_new = [9, 12, 7, 10]
    plain = _serve(TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**_ECFG),
                                  device="cpu"), TS, _PROMPTS, max_new)
    spec = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(
        **_ECFG, spec_tokens=3, draft_blocks=1), device="cpu")
    assert _serve(spec, TS, _PROMPTS, max_new) == plain
    st = spec.stats()["spec"]
    assert st["proposals_accepted"] + st["proposals_rejected"] > 0
