"""The port's serving engine against the JAX package's: the host-side packer,
allocator and metrics, and greedy token streams from the same weights
(fp32, reduced llama3.2-3b), through ragged admission and through
preemption by page pressure."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.obs import metrics as RMET  # noqa: E402
from repro.serve import paged_cache as RPC  # noqa: E402
from repro.serve import scheduler as RS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import metrics as TMET  # noqa: E402
from repro_torch.obs.trace import Tracer, validate_chrome_trace  # noqa: E402
from repro_torch.serve import paged_cache as TPC  # noqa: E402
from repro_torch.serve import sampling as TSP  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402


@pytest.mark.parametrize("seed", range(6))
def test_pack_tokens_matches_reference(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.integers(2, 7))
    lists = [list(rng.integers(0, 100, int(rng.integers(0, 9))))
             for _ in range(S)]
    dec = [bool(rng.integers(0, 2)) and len(x) == 1 for x in lists]
    pos = [int(p) for p in rng.integers(0, 50, S)]
    budget = sum(len(x) for x, d in zip(lists, dec) if d) \
        + int(rng.integers(0, 12))
    cap, rot = int(rng.integers(0, 5)), int(rng.integers(0, 20))
    r = RS.pack_tokens(lists, pos, dec, budget, cap, rot)
    t = TS.pack_tokens(lists, pos, dec, budget, cap, rot)
    for f in ("tokens", "tok_slot", "tok_pos", "seg_last", "n_taken"):
        np.testing.assert_array_equal(getattr(t, f), getattr(r, f))
    assert t.n_live == r.n_live


def test_page_allocator_matches_reference():
    def run(mod):
        a = mod.PageAllocator(9, 4, metrics=None, page_bytes=64)
        t1, t2 = mod.BlockTable(a, 5), mod.BlockTable(a, 5)
        log = [t1.ensure(9), t2.ensure(20), t2.ensure(21), list(t1.pages),
               list(t2.pages), t1.as_row().tolist(),
               t1.internal_fragmentation(9)]
        t1.release()
        log += [t2.ensure(17), a.stats(), mod.pages_needed(17, 4)]
        return log

    assert run(TPC) == run(RPC)


def test_metrics_registry_matches_reference():
    samples = np.random.default_rng(0).lognormal(1.0, 1.5, 500)

    def fill(mod):
        reg = mod.MetricsRegistry()
        reg.counter("c", unit="x").inc(3)
        reg.gauge("g").set(2.5)
        h = reg.histogram("h", unit="ms")
        for v in samples:
            h.record(v)
        h.record(0.0)
        return reg

    r, t = fill(RMET), fill(TMET)
    assert t.to_dict() == r.to_dict()
    assert t.prometheus_text() == r.prometheus_text()


def test_argmax_returns_the_first_maximum():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]])
    assert TSP.greedy(logits).tolist() == [1, 0]
    assert np.asarray(jax.numpy.argmax(logits.numpy(), -1)).tolist() == [1, 0]


# --------------------------------------------------------------------------- #
# the engines
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _models(connection="fal"):
    """Reference weights and their port copy, shared by the tests (neither
    engine writes to its params)."""
    rcfg = ref_config("llama3.2-3b").reduced().replace(connection=connection)
    tcfg = get_config("llama3.2-3b").reduced().replace(connection=connection)
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def _serve(engine, mod, prompts, max_new):
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        engine.submit(mod.ServeRequest(rid=i, prompt=p, max_new=n))
    done = engine.run()
    return {r.rid: (list(map(int, r.generated)), r.truncated) for r in done}


def _compare(ecfg_kw, prompts, max_new, tracer=None):
    rcfg, rparams, tcfg, tparams = _models()
    ref = RS.PagedEngine(rcfg, rparams, RS.EngineConfig(**ecfg_kw))
    port = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**ecfg_kw),
                          tracer=tracer, device="cpu")
    r_out = _serve(ref, RS, prompts, max_new)
    ops.reset_dispatch_paths()
    t_out = _serve(port, TS, prompts, max_new)
    assert t_out == r_out
    rs, ts = ref.stats(), port.stats()
    for key in ("ticks", "packed_calls", "prefill_tokens", "decode_tokens",
                "preemptions", "rejected"):
        assert ts[key] == rs[key], key
    assert ts["pages"]["peak_in_use"] == rs["pages"]["peak_in_use"]
    assert ts["dispatches_per_tick"] == 1.0
    assert ops.dispatch_paths() == {"paged_packed_attention": ops.PLAIN}
    return port, ts


def test_engine_streams_match_reference():
    # the ragged stream of examples/serve_requests.py:49-55
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, 512, 4 + i % 7) for i in range(10)]
    tracer = Tracer(enabled=True)
    port, st = _compare(dict(page_size=8, num_pages=48, slots=4,
                             prefill_chunk=8, max_seq=128),
                        prompts, [8 + 3 * (i % 3) for i in range(10)],
                        tracer=tracer)
    assert st["tokens_per_dispatch"]["count"] == st["ticks"]
    assert st["ttft_ms"]["count"] == 10
    names = {e["name"] for e in tracer.events}
    assert {"engine.tick", "engine.dispatch", "QUEUED", "FINISHED"} <= names
    assert validate_chrome_trace(tracer.export()) > 10


def test_engine_preemption_matches_reference():
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, int(n)) for n in rng.integers(16, 24, 8)]
    _, st = _compare(dict(page_size=4, num_pages=13, slots=3,
                          prefill_chunk=8, max_seq=64),
                     prompts, [6] * 8)
    assert st["preemptions"] > 0


def test_engine_rejects_what_can_never_fit():
    _, st = _compare(dict(page_size=4, num_pages=6, slots=2,
                          prefill_chunk=8, max_seq=32),
                     [np.zeros(40, np.int64), np.arange(6), np.arange(3)],
                     [4, 4, 40])
    assert st["rejected"] == 1


def test_engine_needs_a_device_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means cuda")
    _, _, tcfg, tparams = _models()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.PagedEngine(tcfg, tparams, TS.EngineConfig())


@pytest.mark.parametrize("option,value", [
    ("prefix_cache", True), ("spec_tokens", 4), ("kv_dtype", "int8")])
def test_engine_later_slice_options_raise(option, value):
    _, _, tcfg, tparams = _models()
    with pytest.raises(NotImplementedError, match="later slice"):
        TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**{option: value}),
                       device="cpu")


def test_engine_dual_branch_streams_match_reference_and_sequential():
    """EngineConfig(dual_branch=True): the same greedy streams as the JAX
    package's dual engine and as the port's own non-dual engine (the packed
    dual path runs the sequential path's ops)."""
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, 512, 4 + i % 7) for i in range(6)]
    kw = dict(page_size=8, num_pages=48, slots=4, prefill_chunk=8,
              max_seq=128)
    port, st = _compare(dict(kw, dual_branch=True), prompts, [8] * 6)
    assert port.plan.dual_branch
    _, _, tcfg, tparams = _models()
    seq = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**kw), device="cpu")
    assert _serve(seq, TS, prompts, [8] * 6) == {
        r.rid: (list(map(int, r.generated)), r.truncated)
        for r in port.finished}


def test_engine_dual_branch_rejects_preln_like_reference():
    rcfg, rparams, tcfg, tparams = _models("preln")
    with pytest.raises(ValueError, match="must assemble MHA"):
        RS.PagedEngine(rcfg, rparams, RS.EngineConfig(dual_branch=True))
    with pytest.raises(ValueError, match="must assemble MHA"):
        TS.PagedEngine(tcfg, tparams, TS.EngineConfig(dual_branch=True),
                       device="cpu")


def test_engine_sampled_requests_raise():
    _, _, tcfg, tparams = _models()
    eng = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(), device="cpu")
    req = TS.ServeRequest(rid=0, prompt=np.arange(4), max_new=2,
                          sampling=TSP.SamplingParams(temperature=0.7))
    with pytest.raises(NotImplementedError, match="threefry"):
        eng.submit(req)


def test_packed_step_idle_lane_emits_sentinel():
    _, _, tcfg, tparams = _models()
    eng = TS.PagedEngine(tcfg, tparams, TS.EngineConfig(slots=3),
                         device="cpu")
    bt = torch.zeros((3, eng.max_blocks), dtype=torch.int32)
    bt[0, 0] = 1
    tokens = torch.tensor([5, 6, 0, 0], dtype=torch.int32)
    tok_slot = torch.zeros(4, dtype=torch.int32)
    tok_pos = torch.tensor([0, 1, -1, -1], dtype=torch.int32)
    seg_last = torch.tensor([1, -1, -1], dtype=torch.int32)
    logits, nxt, _ = eng.step_fn(tparams, eng.cache, tokens, tok_slot,
                                 tok_pos, bt, seg_last)
    assert nxt[1:].tolist() == [-1, -1] and 0 <= int(nxt[0]) < tcfg.vocab
    assert torch.isfinite(logits).all()
