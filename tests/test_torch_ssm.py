"""The port's Mamba2 block and the SSM family (mamba2-370m, reduced) against
the JAX package, on the CPU in fp32, weights and inputs carried across from
numpy (``interop.params_from_numpy``):

* every function of ``models/ssm.py`` against the reference's:
  ``_dims``, ``_split_in``, ``_segsum``, ``_causal_conv`` (with and
  without its cache, and streamed token by token through it against the
  whole sequence), ``ssd_chunked`` (with and without ``init_state``, at
  several chunks against one), ``mamba_apply`` (carrying a state and a
  conv window in), ``mamba_init_cache``, ``mamba_decode`` and
  ``mamba_init``'s tree; the ``S % chunk`` refusal;
* the family: forward logits, ``loss_fn`` and every gradient leaf, 20
  ``decode_step`` ticks (logits and the written ``state`` / ``conv``), the
  paged entry points' refusal;
* the batcher repair: a port ``ContinuousBatcher`` with 2 slots and 4
  mamba requests gives every request the stream of the reference's
  ``decode_step`` loop run from a fresh cache for it alone; the first two
  (the slots' first tenants) also equal the reference batcher's streams.
  The reference batcher carries a slot's state into its next request
  (ROADMAP.md Queue 3), so its later streams differ.

Bounds: module outputs, logits and caches 1e-5 of max(1, the largest
value) (fp32 sums in another order); gradients 1e-6 plus 1e-4 of the
leaf's largest value (``test_torch_train.py``'s); token streams
exactly."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.serve import decode as RD  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.serve import decode as TD  # noqa: E402

from test_torch_train import _close_tree  # noqa: E402

ARCH = "mamba2-370m"
TOL = 1e-5
_init = jax.jit(RM.init_params, static_argnums=1)
_ref_step = jax.jit(RM.decode_step, static_argnums=(1, 4))


@functools.lru_cache(maxsize=None)
def models(arch, seed=0, **kw):
    """(reference cfg, reference params, port cfg, port fp32 params) of a
    reduced config, the same weights on both sides."""
    rcfg = ref_config(arch).reduced().replace(**kw)
    tcfg = get_config(arch).reduced().replace(**kw)
    rparams = _init(jax.random.PRNGKey(seed), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu", dtype="float32")
    return rcfg, rparams, tcfg, tparams


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    """Within ``tol`` times max(1, the largest |want|)."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=0)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def init_tree_matches(arch):
    """The port's ``init_params`` tree is the reference's
    ``jax.eval_shape`` tree in the port's layout, leaf for leaf."""
    rcfg, tcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    shapes = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                            jax.random.PRNGKey(0))
    want = interop.params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), tcfg,
        "cpu")
    got = TM.init_params(tcfg, device="cpu")
    got, want = dict(TO.named_leaves(got)), dict(TO.named_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k


def paged_refusals_match(arch):
    """The paged entry points raise the reference's error, word for word,
    for a family without a paged cache."""
    rcfg, tcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    calls = [(lambda M, c, **kw: M.init_paged_cache(c, 8, 4, 2, **kw)),
             (lambda M, c, **kw: M.paged_decode_step({}, c, {}, {})),
             (lambda M, c, **kw: M.paged_spec_draft({}, c, {}, {}))]
    for call in calls:
        with pytest.raises(NotImplementedError) as r_err:
            call(RM, rcfg)
        with pytest.raises(NotImplementedError) as t_err:
            call(TM, tcfg, device="cpu") if call is calls[0] \
                else call(TM, tcfg)
        assert str(t_err.value) == str(r_err.value)


# --------------------------------------------------------------------------- #
# models/ssm.py, function by function
# --------------------------------------------------------------------------- #
def test_dims_split_and_segsum_match_reference():
    cfg = get_config(ARCH).reduced()
    assert TS._dims(cfg) == RS._dims(ref_config(ARCH).reduced())
    d_inner, H, N, _ = TS._dims(cfg)
    rng = np.random.default_rng(0)
    h = _rand(rng, 2, 5, 2 * d_inner + 2 * N + H)
    for got, want in zip(TS._split_in(cfg, torch.from_numpy(h)),
                         RS._split_in(ref_config(ARCH).reduced(),
                                      jnp.asarray(h))):
        np.testing.assert_array_equal(_np(got), _np(want))
    a = -np.abs(_rand(rng, 2, 3, 7))
    got, want = TS._segsum(torch.from_numpy(a)), RS._segsum(jnp.asarray(a))
    np.testing.assert_array_equal(np.isinf(_np(got)), np.isinf(_np(want)))
    fin = np.isfinite(_np(want))
    _close(_np(got)[fin], _np(want)[fin], 1e-6)


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_matches_reference(with_cache):
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 2, 9, 6), _rand(rng, 4, 6), _rand(rng, 6)
    cache = _rand(rng, 2, 3, 6) if with_cache else None
    got = TS._causal_conv(*map(torch.from_numpy, (x, w, b)),
                          None if cache is None else torch.from_numpy(cache))
    want = RS._causal_conv(*map(jnp.asarray, (x, w, b)),
                           None if cache is None else jnp.asarray(cache))
    _close(got[0], want[0])
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


def test_causal_conv_streamed_through_its_cache_equals_whole_sequence():
    rng = np.random.default_rng(2)
    x, w, b = map(torch.from_numpy, (_rand(rng, 2, 11, 5), _rand(rng, 4, 5),
                                     _rand(rng, 5)))
    whole, last = TS._causal_conv(x, w, b)
    cache, outs = torch.zeros((2, 3, 5)), []
    for t in range(x.shape[1]):
        y, cache = TS._causal_conv(x[:, t:t + 1], w, b, cache)
        outs.append(y)
    _close(torch.cat(outs, 1), whole, 1e-6)
    np.testing.assert_array_equal(_np(cache), _np(last))


def _ssd_inputs(seed, b=2, s=64, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(_rand(rng, b, s, h))).astype(np.float32)
    A = -np.exp(_rand(rng, h) * 0.5).astype(np.float32)
    return (_rand(rng, b, s, h, p), dt, A, _rand(rng, b, s, n),
            _rand(rng, b, s, n), _rand(rng, b, h, p, n))


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(chunk, with_state):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(3)
    s0 = s0 if with_state else None
    got = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk,
                         None if s0 is None else torch.from_numpy(s0))
    want = RS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                          None if s0 is None else jnp.asarray(s0))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_ssd_chunks_equal_one_chunk():
    """Four chunks of 16 and their inter-chunk recurrence give what one
    chunk of 64 gives (with a carried-in state too)."""
    x, dt, A, Bm, Cm, s0 = map(torch.from_numpy, _ssd_inputs(4))
    for init in (None, s0):
        y4, f4 = TS.ssd_chunked(x, dt, A, Bm, Cm, 16, init)
        y1, f1 = TS.ssd_chunked(x, dt, A, Bm, Cm, 64, init)
        _close(y4, y1)
        _close(f4, f1)


def test_ssd_refuses_a_ragged_chunk():
    x, dt, A, Bm, Cm, _ = _ssd_inputs(5, s=40)
    with pytest.raises(AssertionError):
        RS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 16)
    with pytest.raises(AssertionError, match="not a multiple"):
        TS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 16)


def _mixer(seed=0):
    rcfg, rparams, tcfg, tparams = models(ARCH, seed)
    return (rcfg, rparams["blocks"]["mixer"], tcfg,
            tparams["blocks"][0]["mixer"],
            jax.tree.map(lambda a: a[0], rparams["blocks"]["mixer"]))


def test_mamba_apply_matches_reference_with_state_and_window_carried_in():
    rcfg, _, tcfg, tp, rp = _mixer()
    d_inner, H, N, conv_dim = TS._dims(tcfg)
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 64, tcfg.d_model)
    s0 = _rand(rng, 2, H, tcfg.ssm_head_dim, N)
    c0 = _rand(rng, 2, tcfg.ssm_conv - 1, conv_dim)
    for carry in ((None, None), (s0, c0)):
        t_in = [None if a is None else torch.from_numpy(a) for a in carry]
        r_in = [None if a is None else jnp.asarray(a) for a in carry]
        y, (st, conv) = TS.mamba_apply(tp, tcfg, torch.from_numpy(x), *t_in)
        ry, (rst, rconv) = RS.mamba_apply(rp, rcfg, jnp.asarray(x), *r_in)
        _close(y, ry)
        _close(st, rst)
        _close(conv, rconv)


def test_mamba_decode_and_cache_match_reference():
    rcfg, _, tcfg, tp, rp = _mixer(1)
    tc = TS.mamba_init_cache(tcfg, 2, torch.float32, "cpu")
    rc = RS.mamba_init_cache(rcfg, 2, "float32")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == {
        k: (v.shape, getattr(torch, str(v.dtype))) for k, v in rc.items()}
    rng = np.random.default_rng(7)
    for t in range(5):
        x = _rand(rng, 2, 1, tcfg.d_model)
        y, tc = TS.mamba_decode(tp, tcfg, torch.from_numpy(x), tc)
        ry, rc = RS.mamba_decode(rp, rcfg, jnp.asarray(x), rc)
        _close(y, ry)
        _close(tc["state"], rc["state"])
        _close(tc["conv"], rc["conv"])


def test_mamba_init_tree_matches_reference():
    init_tree_matches(ARCH)
    p = TM.init_params(get_config(ARCH).reduced(), device="cpu",
                       dtype="bfloat16")
    mixer = p["blocks"][0]["mixer"]
    assert mixer["in_proj"].dtype == torch.bfloat16
    for k in TS.SSM_FP32_LEAVES:
        assert mixer[k].dtype == torch.float32, k


def test_params_from_numpy_keeps_the_ssm_scalars_in_fp32():
    rcfg, rparams, tcfg, _ = models(ARCH)
    served = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                       tcfg.replace(dtype="bfloat16"), "cpu")
    mixer = served["blocks"][1]["mixer"]
    assert mixer["out_proj"].dtype == torch.bfloat16
    for k in TS.SSM_FP32_LEAVES:
        assert mixer[k].dtype == torch.float32
        np.testing.assert_array_equal(
            mixer[k].numpy(), np.asarray(rparams["blocks"]["mixer"][k][1]))


# --------------------------------------------------------------------------- #
# the SSM family
# --------------------------------------------------------------------------- #
def _tokens(cfg, B=2, S=64, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def family_forward_loss_and_grads(arch, batch_fn=None, seed=2, **kw):
    """Forward logits, loss / ce and every gradient leaf of ``arch``
    against the reference; ``batch_fn(rcfg)`` -> numpy batch."""
    rcfg, rparams, tcfg, tparams = models(arch, seed, **kw)
    batch = batch_fn(rcfg) if batch_fn else {"tokens": _tokens(rcfg)}
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    r_logits = RM.forward(rparams, rcfg, rb)[0]
    (r_loss, r_m), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b), has_aux=True))(rparams, rb)
    with torch.no_grad():
        _close(TM.forward(tparams, tcfg, tb)[0], r_logits)
    for _, p in TO.named_leaves(tparams):
        p.requires_grad_(True)
    loss, m = TM.loss_fn(tparams, tcfg, tb)
    loss.backward()
    assert abs(loss.item() - float(r_loss)) <= TOL
    assert abs(m["ce"].item() - float(r_m["ce"])) <= TOL
    _close_tree(jax.tree.map(np.asarray, grads),
                TO.map_tree(lambda p: p.grad, tparams), tcfg, 1e-6, 1e-4)
    for _, p in TO.named_leaves(tparams):
        p.requires_grad_(False)
        p.grad = None


def test_forward_loss_and_gradients_match_reference():
    family_forward_loss_and_grads(ARCH)


def decode_matches_reference(arch, n=20, plan=None, prepare=None, **kw):
    """``n`` decode_step ticks at ragged positions against the reference's
    from the same cache; the logits and every cache leaf within TOL.
    ``prepare(rcfg, rparams, tcfg, tparams, rc, tc)`` fills the caches
    first (whisper's enc_out)."""
    rcfg, rparams, tcfg, tparams = models(arch, **kw)
    B = 2
    rc = RM.init_cache(rcfg, B, n + 4, "float32")
    tc = TM.init_cache(tcfg, B, n + 4, "float32", device="cpu")
    if prepare:
        rc = prepare(rcfg, rparams, tcfg, tparams, rc, tc)
    toks = _tokens(rcfg, B, n, seed=3)
    for t in range(n):
        pos = np.array([t, t // 2], np.int32)
        r_logits, rc = _ref_step(rparams, rcfg,
                                 {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                  "pos": jnp.asarray(pos)}, rc, plan[0]
                                 if plan else None)
        with torch.no_grad():
            t_logits, tc = TM.decode_step(
                tparams, tcfg, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                "pos": torch.from_numpy(pos)}, tc,
                plan[1] if plan else None)
        _close(t_logits, r_logits)
    got = dict(TO.named_leaves(tc))
    want = {k: v for k, v in TO.named_leaves(jax.tree.map(np.asarray, rc))}
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])


def test_decode_step_matches_reference():
    decode_matches_reference(ARCH)


def test_paged_entry_points_refuse_like_reference():
    paged_refusals_match(ARCH)
    with pytest.raises(NotImplementedError, match="ssm"):
        from repro_torch.serve.scheduler import PagedEngine
        PagedEngine(get_config(ARCH).reduced(), {}, device="cpu")


# --------------------------------------------------------------------------- #
# the batcher repair
# --------------------------------------------------------------------------- #
def _lone(rparams, rcfg, prompt, max_new, max_seq):
    """The reference's decode_step loop from a fresh cache, one request."""
    cache = RM.init_cache(rcfg, 1, max_seq, "float32")
    out, tok = [], None
    for t in range(len(prompt) + max_new - 1):
        cur = prompt[t] if t < len(prompt) else tok
        logits, cache = _ref_step(
            rparams, rcfg, {"tokens": jnp.asarray([[cur]], jnp.int32),
                            "pos": jnp.asarray([t], jnp.int32)}, cache, None)
        tok = int(np.argmax(np.asarray(logits)[0, -1]))
        if t >= len(prompt) - 1:
            out.append(tok)
    return out


@pytest.mark.parametrize("arch", [ARCH, "zamba2-1.2b"])
def test_batcher_reused_slots_serve_each_request_as_alone(arch):
    """2 slots, 4 requests: the last two reuse the slots the first two
    left.  Each stream equals the request's lone stream; the first two
    also the reference batcher's (whose reused slots start from the last
    request's state)."""
    rcfg, rparams, tcfg, tparams = models(arch)
    rng = np.random.default_rng(8)
    reqs = [(i, rng.integers(0, rcfg.vocab, 6 + i), 5 + 2 * i)
            for i in range(4)]
    max_seq = 32
    streams = {}
    for mod, cfg, params, kw in ((RD, rcfg, rparams, {}),
                                 (TD, tcfg, tparams, {"device": "cpu"})):
        eng = mod.ContinuousBatcher(cfg, params, batch_slots=2,
                                    max_seq=max_seq, **kw)
        for rid, prompt, max_new in reqs:
            eng.submit(mod.Request(rid=rid, prompt=prompt, max_new=max_new))
        streams[mod] = {r.rid: r.generated for r in eng.run()}
    for rid, prompt, max_new in reqs:
        assert streams[TD][rid] == _lone(rparams, rcfg, prompt, max_new,
                                         max_seq), rid
    for rid in (0, 1):
        assert streams[TD][rid] == streams[RD][rid]


@pytest.mark.parametrize("arch", [ARCH, "zamba2-1.2b", "whisper-small"])
def test_cache_from_numpy_carries_each_family_cache(arch):
    """A reference cache after 6 ticks (mamba's stacked state / conv,
    zamba's groups and attention K / V, whisper's K / V and enc_out)
    crosses with ``interop.cache_from_numpy`` leaf for leaf, and 6 more
    port ticks from it give the reference's logits."""
    kw = {"n_layers": 5} if arch.startswith("zamba") else {}
    rcfg, rparams, tcfg, tparams = models(arch, **kw)
    rc = RM.init_cache(rcfg, 2, 12, "float32")
    if rcfg.family == "audio":
        fr = np.random.default_rng(4).standard_normal(
            (2, rcfg.n_enc_frames, rcfg.d_model)).astype(np.float32)
        rc = dict(rc, enc_out=RM.whisper_encode(rparams, rcfg,
                                                jnp.asarray(fr)))
    toks = _tokens(rcfg, 2, 12, seed=6)

    def batch(t, mod):
        b = {"tokens": toks[:, t:t + 1], "pos": np.full((2,), t, np.int32)}
        return {k: (jnp.asarray(v) if mod is RM else torch.from_numpy(v))
                for k, v in b.items()}

    for t in range(6):
        _, rc = _ref_step(rparams, rcfg, batch(t, RM), rc, None)
    tc = interop.cache_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    for (k, got), (_, want) in zip(TO.named_leaves(tc), TO.named_leaves(
            jax.tree.map(np.asarray, rc))):
        assert str(got.dtype) == f"torch.{want.dtype}", k
        np.testing.assert_array_equal(got.numpy(), want)
    for t in range(6, 12):
        r_logits, rc = _ref_step(rparams, rcfg, batch(t, RM), rc, None)
        with torch.no_grad():
            t_logits, tc = TM.decode_step(tparams, tcfg, batch(t, TM), tc)
        _close(t_logits, r_logits)
