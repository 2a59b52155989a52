"""The port's contiguous-cache decode against the JAX package: ``init_cache``
/ ``decode_step`` logits and written caches against the reference's
(fal, preln, and reduced gemma2 with a window shorter than the sequence),
decode against the port's own ``forward`` at aligned and ragged positions
(``tests/test_decode_equiv.py:13``, ``:46``), dual-branch decode bit-exact
to sequential (``tests/test_dual_branch.py:113``), ``serve.decode``'s
prefill-by-decode generator and ``ContinuousBatcher`` against the
reference's (greedy streams token for token, ``stats()`` equal;
``tests/test_train_substrate.py:80``, ``:97``), and ``obs.run_metadata``.

fp32 throughout; logits and caches agree within 1e-4 (two layers of fp32
matmuls summed in another order, activations of order 1), tighter than the
reference's own decode-vs-forward bound of 2e-3."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.core.plan import ExecutionPlan as RPlan  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import decode as RD  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import fal  # noqa: E402
from repro_torch.core.plan import ExecutionPlan as TPlan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.obs import run_metadata  # noqa: E402
from repro_torch.serve import decode as TD  # noqa: E402

TOL = 1e-4
B, S = 2, 12
_init = jax.jit(RM.init_params, static_argnums=1)
_ref_step = jax.jit(RM.decode_step, static_argnums=(1, 4))


@functools.lru_cache(maxsize=None)
def _models(arch, connection, **kw):
    rcfg = ref_config(arch).reduced().replace(connection=connection, **kw)
    tcfg = get_config(arch).reduced().replace(connection=connection, **kw)
    rparams = _init(jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _ragged_ticks():
    """Per-tick lane positions: lane 0 advances every tick, lane 1 every
    second tick (re-decoding its (token, position) in between), as in
    ``tests/test_decode_equiv.py:46``."""
    return [(t, t // 2) for t in range(S)]


def _decode(tcfg, tparams, toks, ticks, dual=False):
    """Drive the port's ``decode_step`` -> ((ticks, B, V) logits, cache)."""
    plan = TPlan.single_device("decode", dual_branch=dual)
    cache = TM.init_cache(tcfg, B, S, "float32", device="cpu")
    outs = []
    for pos in ticks:
        lg, cache = TM.decode_step(
            tparams, tcfg, {"tokens": torch.from_numpy(
                toks[np.arange(B), list(pos)][:, None]),
                "pos": torch.tensor(pos, dtype=torch.int32)}, cache, plan)
        assert lg.shape == (B, 1, tcfg.vocab)
        outs.append(lg[:, 0].numpy())
    return np.stack(outs), cache


@pytest.mark.parametrize("arch,connection,kw", [
    ("llama3.2-3b", "fal", {}), ("llama3.2-3b", "preln", {}),
    ("gemma2-27b", "fal", {"sliding_window": 6})],
    ids=["llama-fal", "llama-preln", "gemma2-window6"])
def test_decode_step_matches_reference(arch, connection, kw):
    """Ragged positions through S ticks: every tick's logits and, at the
    end, every layer's K/V cache equal the reference's.  gemma2's window
    of 6 < S binds on its local layer, with both softcaps on."""
    rcfg, rparams, tcfg, tparams = _models(arch, connection,
                                           **dict(sorted(kw.items())))
    assert not kw or TM.BL.window_schedule(tcfg)[0] < S
    toks = _tokens(rcfg.vocab)
    ticks = _ragged_ticks()
    rc = RM.init_cache(rcfg, B, S, "float32")
    r_out = []
    for pos in ticks:
        lg, rc = _ref_step(rparams, rcfg, {
            "tokens": jnp.asarray(toks[np.arange(B), list(pos)][:, None]),
            "pos": jnp.asarray(pos, jnp.int32)}, rc,
            RPlan.single_device("decode"))
        r_out.append(np.asarray(lg[:, 0]))
    ops.reset_dispatch_paths()
    t_out, tc = _decode(tcfg, tparams, toks, ticks)
    np.testing.assert_allclose(t_out, np.stack(r_out), atol=TOL, rtol=0)
    for part in ("block0", "blocks"):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[part][name].numpy(),
                                       np.asarray(rc[part][name]),
                                       atol=TOL, rtol=0)
    fused = connection in fal.FUSED_LN_ADD_MODES
    assert ("fused_ln_add" in ops.dispatch_paths()) == fused


def test_bf16_model_over_fp32_cache_promotes_like_reference():
    """A bf16 model over the batcher's default fp32 cache: the attention
    output is fp32 and promotes the residual stream, as the reference's
    ``o @ wo.astype(x.dtype)`` does, so the logits come out fp32 on both
    sides; bf16 projections rounded in another order: within 1e-2, a few
    bf16 ulps (2^-8 below 1) of logits below 1."""
    rcfg, rparams, tcfg, tparams = _models("llama3.2-3b", "fal",
                                           dtype="bfloat16")
    toks = _tokens(rcfg.vocab, seed=5)
    ticks = _ragged_ticks()[:4]
    rc = RM.init_cache(rcfg, B, S, "float32")
    tc = TM.init_cache(tcfg, B, S, "float32", device="cpu")
    for pos in ticks:
        cur = toks[np.arange(B), list(pos)][:, None]
        r, rc = _ref_step(rparams, rcfg, {
            "tokens": jnp.asarray(cur), "pos": jnp.asarray(pos, jnp.int32)},
            rc, RPlan.single_device("decode"))
        t, tc = TM.decode_step(tparams, tcfg, {
            "tokens": torch.from_numpy(cur),
            "pos": torch.tensor(pos, dtype=torch.int32)}, tc)
        assert r.dtype == np.float32 and t.dtype == torch.float32
        assert np.abs(np.asarray(r)).max() < 1.0
        np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=1e-2,
                                   rtol=0)


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_matches_forward(ragged):
    """``tests/test_decode_equiv.py:13`` / ``:46`` on the port alone: each
    lane's logit at position p equals the full-sequence forward's row p."""
    _, _, tcfg, tparams = _models("llama3.2-3b", "fal")
    toks = _tokens(tcfg.vocab, seed=2)
    full = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                      "train")[0].numpy()
    ticks = _ragged_ticks() if ragged else [(t, t) for t in range(S)]
    dec, _ = _decode(tcfg, tparams, toks, ticks)
    for i, pos in enumerate(ticks):
        for b in range(B):
            np.testing.assert_allclose(dec[i, b], full[b, pos[b]],
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize("connection", fal.DUAL_BRANCH_MODES)
def test_dual_branch_bit_exact_contiguous_decode(connection):
    """``tests/test_dual_branch.py:113``: decode_step under a dual-branch
    plan runs the same ops as the sequential one (no fused route on the
    contiguous cache), so the logits are equal bit for bit."""
    _, _, tcfg, tparams = _models("llama3.2-3b", connection)
    toks = _tokens(tcfg.vocab, seed=3)
    seq, _ = _decode(tcfg, tparams, toks, _ragged_ticks())
    dual, _ = _decode(tcfg, tparams, toks, _ragged_ticks(), dual=True)
    assert np.array_equal(seq, dual)


def test_sharded_plan_refused():
    """The serving ticks run under an explicit-TP plan
    (``test_torch_tp_serving.py``, and for the ssm / hybrid / audio
    families ``test_torch_family_tp.py``); what still raises: a process
    group without ``tp='explicit'``, a data-parallel group (a data replica
    is an engine of its own), and sequence parallelism for those families
    (mamba layers have no SP layout; cross-attention and bidirectional
    encoders consume the assembled attention)."""
    import types
    _, _, tcfg, tparams = _models("llama3.2-3b", "fal")
    group = types.SimpleNamespace(size=lambda: 2, rank=lambda: 0)
    cache = TM.init_cache(tcfg, B, S, "float32", device="cpu")
    batch = {"tokens": torch.zeros((B, 1), dtype=torch.int32),
             "pos": torch.zeros((B,), dtype=torch.int32)}
    plan = TPlan.from_group(group, tp="none", phase="decode")
    with pytest.raises(NotImplementedError, match="tp='explicit'"):
        TM.decode_step(tparams, tcfg, batch, cache, plan)
    with pytest.raises(NotImplementedError, match="tp='explicit'"):
        TM.paged_decode_step(tparams, tcfg, {"tok_slot": None}, None, plan)
    dp = TPlan.from_group(None, tp="none", data_group=group)
    with pytest.raises(ValueError, match="separate engine"):
        TM.decode_step(tparams, tcfg, batch, cache, dp)
    ssm = get_config("mamba2-370m").reduced()
    with pytest.raises(NotImplementedError, match="tp='explicit'"):
        TM.decode_step(None, ssm, batch, None,
                       TPlan.from_group(group, tp="none"))
    for arch in ("mamba2-370m", "zamba2-1.2b", "whisper-small"):
        with pytest.raises(NotImplementedError, match="sequence-parallel"):
            TPlan.from_group(group, tp="explicit", sp=True).validate(
                get_config(arch).reduced())
        with pytest.raises(ValueError, match="needs tp='explicit'"):
            TPlan.from_group(group, tp="none").validate(
                get_config(arch).reduced())
    # mamba2's mixers stay whole on every rank: its rank cache is the
    # one-device cache, and the explicit plan serves it
    shard = TM.init_cache(ssm, B, S, "float32", device="cpu", tp_size=2)
    whole = TM.init_cache(ssm, B, S, "float32", device="cpu")
    assert {k: v.shape for k, v in shard["blocks"].items()} == \
        {k: v.shape for k, v in whole["blocks"].items()}
    plan = TPlan.from_group(group, tp="explicit")
    assert TM.serving_plan({}, ssm, plan, "decode").use_explicit_tp


def test_prefill_then_decode_matches_reference():
    rcfg, rparams, tcfg, tparams = _models("llama3.2-3b", "fal")
    prompts = _tokens(rcfg.vocab, seed=4)[:, :5]
    r, _ = RD.make_prefill_then_decode(rcfg)(
        rparams, prompts, 4, RM.init_cache(rcfg, B, S, "float32"))
    t, _ = TD.make_prefill_then_decode(tcfg)(
        tparams, prompts, 4, TM.init_cache(tcfg, B, S, "float32",
                                           device="cpu"))
    assert t.dtype == np.int32 and np.array_equal(t, np.asarray(r))


def _tiny(mod):
    # tests/test_train_substrate.py:19 tiny_cfg(connection="fal")
    return mod("gpt2-117m").reduced().replace(vocab=256, max_seq=64,
                                              connection="fal")


def _batchers(slots, max_seq, reqs):
    """The reference's and the port's batcher from the same weights, fed
    the same (rid, prompt, max_new) requests -> ({rid: stream}, stats) for
    each."""
    rcfg, tcfg = _tiny(ref_config), _tiny(get_config)
    rparams = _init(jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    out = []
    for mod, cfg, params, kw in ((RD, rcfg, rparams, {}),
                                 (TD, tcfg, tparams, {"device": "cpu"})):
        eng = mod.ContinuousBatcher(cfg, params, batch_slots=slots,
                                    max_seq=max_seq, **kw)
        for rid, prompt, max_new in reqs:
            eng.submit(mod.Request(rid=rid, prompt=prompt, max_new=max_new))
        done = eng.run()
        assert all(r.done for r in done)
        out.append(({r.rid: r.generated for r in done}, eng.stats()))
    return out


def test_batcher_matches_reference_end_to_end():
    """``tests/test_train_substrate.py:80``'s workload: five requests
    through two slots; every stream and the stats (ticks, dispatches,
    occupancy, the metrics registry's export) equal the reference's."""
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(0, 256, 5), 4 + i) for i in range(5)]
    (r, r_stats), (t, t_stats) = _batchers(2, 48, reqs)
    assert t == r and len(t) == 5
    for rid, _, max_new in reqs:
        assert len(t[rid]) == max_new
        assert all(0 <= tok < 256 for tok in t[rid])
    assert t_stats == r_stats and t_stats["dispatches_per_tick"] == 1.0


def test_batcher_lone_request_equals_batched():
    """``tests/test_train_substrate.py:97``: a request's tokens do not
    depend on what shares the batch; both sides equal the reference's."""
    prompt = np.arange(1, 7) % 256
    (r1, r1_stats), (t1, t1_stats) = _batchers(1, 32, [(0, prompt, 5)])
    (r2, r2_stats), (t2, t2_stats) = _batchers(
        2, 32, [(0, prompt, 5), (1, prompt[::-1].copy(), 7)])
    assert t1 == r1 and t2 == r2 and t2[0] == t1[0]
    assert t1_stats == r1_stats and t2_stats == r2_stats


def test_run_metadata_on_cpu():
    ops.reset_dispatch_paths()
    meta = run_metadata(timestamp=12.5, repo_dir=".",
                        dispatch_paths={"fused_ln_add": "cpu-plain"})
    for key in ("git_sha", "torch_version", "cuda_version", "backend",
                "device_kind", "device_count", "python", "platform"):
        assert key in meta, key
    assert meta["torch_version"] == torch.__version__
    assert meta["timestamp"] == 12.5
    assert meta["dispatch_paths"] == {"fused_ln_add": "cpu-plain"}
    assert not any("jax" in k for k in meta)
    if not torch.cuda.is_available():
        assert meta["device_kind"] == "cpu" and "power_limit" not in meta
