"""Self-speculative decoding on the port's packed engine
(``EngineConfig.spec_tokens``), twins of ``tests/test_spec_decode.py``: the
early-exit draft proposes n-1 tokens a decode lane inside the tick's one
model call, the full-depth packed forward verifies them, and exact-match
acceptance keeps greedy and seeded streams equal to non-speculative decode
and to the JAX spec engine's, through the six connection styles, the
dual-branch plan, preemption, prefix-cache rollback, int8 pages and the
fallback near ``max_seq``; every page is back in the pool at the end."""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import sampling as RSP  # noqa: E402
from repro.serve import scheduler as RS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import sampling as TSP  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402

SIX_STYLES = ("preln", "parallel", "fal", "falplus", "ablation1", "ablation2")

BASE = TS.EngineConfig(page_size=8, num_pages=48, slots=4, prefill_chunk=8,
                       max_seq=64)
# the reduced config has 2 layers, so the draft runs block 0 only
SPEC = dataclasses.replace(BASE, spec_tokens=4, draft_blocks=1)


@functools.lru_cache(maxsize=None)
def _models(conn="fal"):
    rcfg = ref_config("llama3.2-3b").reduced().replace(connection=conn)
    tcfg = get_config("llama3.2-3b").reduced().replace(connection=conn)
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def _reqs(mod, sp_mod, n=4, seed=1, temp=0.0, rid0=0):
    rng = np.random.default_rng(seed)
    return [mod.ServeRequest(
        rid=rid0 + i, prompt=rng.integers(0, 512, 4 + i % 7),
        max_new=6 + 3 * (i % 3),
        sampling=sp_mod.SamplingParams(temperature=temp, top_k=50,
                                       top_p=0.95, seed=i))
        for i in range(n)]


def _run(ecfg, reqs, conn="fal"):
    _, _, tcfg, tparams = _models(conn)
    eng = TS.PagedEngine(tcfg, tparams, ecfg, device="cpu")
    for r in reqs:
        eng.submit(r)
    done = eng.run(max_ticks=500)
    assert len(done) == len(reqs)
    return {r.rid: list(map(int, r.generated)) for r in done}, eng


def test_spec_streams_match_reference_and_plain_decode():
    """Greedy, then seeded requests through one JAX spec engine and one
    port spec engine: the port's streams equal the JAX engine's and the
    port's non-spec engine's, and ``stats()["spec"]`` is the reference's."""
    rcfg, rparams, tcfg, tparams = _models()
    kw = {f.name: getattr(SPEC, f.name) for f in dataclasses.fields(SPEC)}
    ref = RS.PagedEngine(rcfg, rparams, RS.EngineConfig(**kw))
    port = TS.PagedEngine(tcfg, tparams, SPEC, device="cpu")
    for temp, rid0 in ((0.0, 0), (0.9, 10)):
        for r in _reqs(RS, RSP, temp=temp, rid0=rid0):
            ref.submit(r)
        for r in _reqs(TS, TSP, temp=temp, rid0=rid0):
            port.submit(r)
        ref.run(max_ticks=500)
        port.run(max_ticks=500)
        plain, _ = _run(BASE, _reqs(TS, TSP, temp=temp, rid0=rid0))
        got = {r.rid: list(map(int, r.generated)) for r in port.finished
               if r.rid >= rid0}
        assert got == plain, temp
        assert got == {r.rid: list(map(int, r.generated))
                       for r in ref.finished if r.rid >= rid0}, temp
    st, rst = port.stats(), ref.stats()
    assert st["spec"] == rst["spec"]
    assert st["spec"]["proposals_accepted"] > 0
    assert st["spec"]["accepted_len"]["mean"] > 1.0
    for key in ("ticks", "decode_tokens", "prefill_tokens", "preemptions"):
        assert st[key] == rst[key], key
    assert port.allocator.in_use == 0


@pytest.mark.parametrize("conn", SIX_STYLES)
def test_spec_identity_styles(conn):
    """Port spec = port non-spec, greedy and seeded, in one model call a
    tick, for every connection style."""
    for temp in (0.0, 0.9):
        ref, _ = _run(BASE, _reqs(TS, TSP, temp=temp), conn)
        got, eng = _run(SPEC, _reqs(TS, TSP, temp=temp), conn)
        assert got == ref, (conn, temp)
        st = eng.stats()
        assert st["dispatches_per_tick"] == 1.0, (conn, temp)
        assert st["spec"]["proposals_accepted"] \
            + st["spec"]["proposals_rejected"] > 0
        assert eng.allocator.in_use == 0


def test_spec_dual_branch():
    for temp in (0.0, 0.9):
        ref, _ = _run(BASE, _reqs(TS, TSP, temp=temp))
        got, eng = _run(dataclasses.replace(SPEC, dual_branch=True),
                        _reqs(TS, TSP, temp=temp))
        assert eng.plan.dual_branch
        assert got == ref, temp
        assert eng.allocator.in_use == 0


def test_spec_preemption_mid_speculation():
    ref, _ = _run(BASE, _reqs(TS, TSP, n=10, temp=0.9))
    got, eng = _run(dataclasses.replace(SPEC, num_pages=9),
                    _reqs(TS, TSP, n=10, temp=0.9))
    assert eng.stats()["preemptions"] > 0
    assert got == ref
    assert eng.allocator.in_use == 0


def test_spec_prefix_cache_rollback_keeps_shared_pages():
    """A full-prompt hit speculates over shared pages; rollback drops only
    the table's own references, the streams equal the non-spec engine's,
    and draining the tree empties the pool."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, 17)

    def run(ecfg):
        _, _, tcfg, tparams = _models()
        eng = TS.PagedEngine(tcfg, tparams, ecfg, device="cpu")
        for i in range(2):
            eng.submit(TS.ServeRequest(
                rid=i, prompt=prompt, max_new=8,
                sampling=TSP.SamplingParams(temperature=0.9, top_k=50,
                                            seed=7)))
            eng.run()
        return {r.rid: list(r.generated) for r in eng.finished}, eng

    ref, _ = run(dataclasses.replace(BASE, prefix_cache=True))
    got, eng = run(dataclasses.replace(SPEC, prefix_cache=True))
    assert got == ref and got[0] == got[1]
    st = eng.stats()
    assert st["prefix"]["hits"] >= 1
    assert st["spec"]["proposals_accepted"] > 0
    assert eng.allocator.in_use == st["prefix"]["cached_pages"]
    eng.pcache.evict(eng.allocator.capacity)
    assert eng.allocator.in_use == 0


def test_quantized_spec_decode_identity():
    """Twin of ``tests/test_quantized_kv.py:317``: draft, verify and
    rollback over int8 pages and their scale pools; the draft's sites record
    ``<site>.int8.draft``."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 512, n) for n in (5, 9)]

    def reqs():
        return [TS.ServeRequest(rid=i, prompt=p, max_new=12)
                for i, p in enumerate(prompts)]

    plain, _ = _run(dataclasses.replace(BASE, kv_dtype="int8"), reqs())
    ops.reset_dispatch_paths()
    got, eng = _run(dataclasses.replace(BASE, kv_dtype="int8",
                                        spec_tokens=3, draft_blocks=1),
                    reqs())
    assert got == plain
    assert eng.stats()["dispatches_per_tick"] == 1.0
    assert ops.dispatch_paths()["paged_packed_attention.int8.draft"] \
        == ops.PLAIN


def test_spec_near_max_seq_falls_back_to_plain_decode():
    reqs = lambda: [TS.ServeRequest(rid=0, prompt=np.arange(15),  # noqa
                                    max_new=20)]
    ref, _ = _run(dataclasses.replace(BASE, max_seq=24), reqs())
    got, eng = _run(dataclasses.replace(SPEC, max_seq=24), reqs())
    assert got == ref
    assert eng.finished[0].truncated
    assert eng.allocator.in_use == 0


def test_spec_config_validation():
    """The reference's construction errors, message for message."""
    rcfg, rparams, tcfg, tparams = _models()
    for bad in (dict(spec_tokens=1),
                dict(spec_tokens=4, draft_blocks=0),
                dict(spec_tokens=4, draft_blocks=tcfg.n_layers),
                dict(spec_tokens=4, draft_blocks=1, token_budget=7)):
        ecfg = dataclasses.replace(BASE, **bad)
        with pytest.raises(ValueError) as want:
            RS.PagedEngine(rcfg, rparams, RS.EngineConfig(**{
                f.name: getattr(ecfg, f.name)
                for f in dataclasses.fields(ecfg)}))
        with pytest.raises(ValueError) as got:
            TS.PagedEngine(tcfg, tparams, ecfg, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="draft_blocks=2 must satisfy"):
        M.paged_spec_draft(tparams, tcfg, {}, {}, draft_blocks=tcfg.n_layers)


def test_spec_one_model_call_a_tick_and_draft_telemetry(monkeypatch):
    """The verify runs once a tick over the whole budget, the draft n-1
    times over (S,) rows on ticks with a speculating lane, and the draft's
    dispatches show as ``<site>.draft``."""
    verify, draft = [], []
    ov, od = M.paged_decode_step, M.paged_spec_draft

    def cv(params, cfg_, batch, cache, plan=None, **kw):
        verify.append(tuple(batch["tokens"].shape))
        return ov(params, cfg_, batch, cache, plan, **kw)

    def cd(params, cfg_, batch, cache, plan=None, **kw):
        draft.append(tuple(batch["tokens"].shape))
        return od(params, cfg_, batch, cache, plan, **kw)

    monkeypatch.setattr(M, "paged_decode_step", cv)
    monkeypatch.setattr(M, "paged_spec_draft", cd)
    ops.reset_dispatch_paths()
    _, eng = _run(SPEC, _reqs(TS, TSP))
    st = eng.stats()
    # budget = slots * spec + chunk - 1 = 4 * 4 + 8 - 1 = 23
    assert st["token_budget"] == 23
    assert set(verify) == {(23,)} and len(verify) == st["ticks"]
    assert set(draft) == {(4,)} and len(draft) % 3 == 0
    assert 0 < len(draft) < 3 * st["ticks"]    # prefill-only ticks skip it
    assert ops.dispatch_paths() == {
        "paged_packed_attention": ops.PLAIN, "fused_ln_add": ops.PLAIN,
        "paged_packed_attention.draft": ops.PLAIN,
        "fused_ln_add.draft": ops.PLAIN}
    assert st["dispatches_per_tick"] == 1.0
    assert st["packed_calls"] == st["ticks"]


def test_spec_tick_leaves_a1_sig_to_the_verify():
    """The draft writes no ``a1_sig``: after a spec tick the per-slot
    signal is the verify's, row for row the plain packed tick's over the
    same buffer with the draft's tokens in it."""
    _, _, tcfg, tparams = _models()
    eng = TS.PagedEngine(tcfg, tparams, SPEC, device="cpu")
    eng.submit(TS.ServeRequest(rid=0, prompt=np.arange(5), max_new=9))
    eng.step()                                  # prefill + first token
    sig0 = eng.cache["a1_sig"].clone()
    step = TS.make_spec_step(tcfg, eng.plan, spec_tokens=4, draft_blocks=1,
                             sampler=TSP.greedy_sampler)
    pt = eng._plan_pack()
    eng._ensure(0, eng.slots[0].pos + int(pt.n_taken[0]))
    bt = torch.from_numpy(np.stack([t.as_row() for t in eng.tables]))
    args = [torch.from_numpy(a) for a in (pt.tokens, pt.tok_slot,
                                          pt.tok_pos)]
    S = SPEC.slots
    mask = torch.zeros(S, dtype=torch.bool)
    mask[0] = True
    samp = (torch.zeros(S), torch.zeros(S, dtype=torch.int32),
            torch.ones(S), torch.zeros(S, dtype=torch.int32))
    seg_last = torch.from_numpy(pt.seg_last)
    cache = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                 else v.clone()) for k, v in eng.cache.items()}
    tgt, fed, cache = step(tparams, cache, *args, bt, seg_last, mask, *samp)
    plain = TS.make_packed_step(tcfg, eng.plan, sampler=TSP.greedy_sampler)
    ref_cache = {k: ({n: t.clone() for n, t in v.items()}
                     if isinstance(v, dict) else v.clone())
                 for k, v in eng.cache.items()}
    args[0][:4] = fed[0]                        # lane 0's rows 0..3
    _, _, ref_cache = plain(tparams, ref_cache, *args, bt, seg_last, *samp,
                            torch.zeros(S, dtype=torch.int32))
    assert torch.equal(cache["a1_sig"], ref_cache["a1_sig"])
    assert not torch.equal(cache["a1_sig"][0], sig0[0])
    assert (fed[0] >= 0).all() and (tgt[0] >= 0).all()
