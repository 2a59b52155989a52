"""Explicit tensor parallelism in the port's serving ticks against the JAX
package's single device, on the CPU: ONE spawn of two ranks over gloo
(``core.tp.run_ranks``, one intra-op thread a rank, rank code in
``tests/torch_tp_serve_ranks.py``) serves, under
``ExecutionPlan.from_group(group, tp="explicit")``, the reduced
llama3.2-3b at 4 layers in fp32 on the reference's weights drawn with
numpy (``test_torch_tp._weights``), each rank on its shard and its KV
heads:

* (a) a token-packed tick on a cache with history, for the six modes, the
  KV heads replicated (``n_kv_heads = 1`` at tp = 2), the reduced
  qwen3-moe-30b-a3b and the reduced llava (rows with image embeddings);
* (b) padded chunk and C == 1 ticks, sequential and dual-branch;
* (c) contiguous ``decode_step`` ticks at ragged positions, and the
  ``ContinuousBatcher``;
* (d) ``PagedEngine`` greedy streams through a prefix hit, a
  copy-on-write and preemptions, and seeded and speculative streams;
* (e) int8 and fp8 pages: the pools the ranks write, gathered over heads,
  against the one-device port's, and the quantized engine's streams;
* (f) both ranks' streams and packs, and each tick's collectives.

The reference's own TP paths are not used: they fail under jax 0.9
(ROADMAP.md Queue 3).

Tolerances: fp32 logits 1e-5 (``test_torch_tp.py``'s); token streams
exact.  Quantized pools: the codes byte for byte, block 0's row scales bit
for bit; the later layers' scales within 1e-6 relative, since after the
first all-reduce the residual stream is the one-device stream up to fp32
rounding (one device sums all heads in one product, two ranks sum halves
and add), and the scale is a function of it.  The scatter alone, on the
same K / V, gives the one-device bytes and scales exactly (the MAX
all-reduce of each row's amax), where per-rank amaxes would not.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.core.plan import ExecutionPlan as RPlan  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import decode as RD  # noqa: E402
from repro.serve import sampling as RSP  # noqa: E402
from repro.serve import scheduler as RS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
import torch_tp_serve_ranks as SR  # noqa: E402
from test_torch_model import _packed_batch  # noqa: E402
from test_torch_quantized_kv import _bytes  # noqa: E402
from test_torch_tp import _ref_cfg, _weights  # noqa: E402

TOL = 1e-5
L = 4
#: sum all-reduces of one forward tick at L = 4 (block 0's extra one under
#: fal; ``test_torch_tp_structure.py``'s forward counts)
TICK_ALL_REDUCES = {"preln": 8, "fal": 5, "parallel": 4, "falplus": 8,
                    "ablation1": 8, "ablation2": 5}
CASES = {**{m: dict(connection=m) for m in R.MODES},
         "kv1": dict(connection="fal", n_kv_heads=1),
         "moe": dict(connection="fal", arch="qwen3-moe-30b-a3b"),
         "llava": dict(connection="fal", arch="llava-next-mistral-7b")}
PADDED = [(m, C, dual) for m in ("fal", "parallel", "preln")
          for C in (4, 1) for dual in (False, True)
          if not (dual and m == "preln")]
CONTIGUOUS = [("fal", False), ("fal", True), ("preln", False),
              ("kv1", False), ("moe", False)]
BATCH, SEQ = 2, 12
GREEDY_ECFG = dict(page_size=4, num_pages=14, slots=3, prefill_chunk=8,
                   max_seq=64, prefix_cache=True)
SAMPLED_ECFG = dict(page_size=8, num_pages=48, slots=4, prefill_chunk=8,
                    max_seq=64)
ENGINES = {"greedy": ("fal", GREEDY_ECFG, "prefix"),
           "seeded": ("fal", SAMPLED_ECFG, "sampled"),
           "spec": ("fal", dict(SAMPLED_ECFG, spec_tokens=3, draft_blocks=2),
                    "sampled"),
           "int8": ("fal", dict(GREEDY_ECFG, kv_dtype="int8"), "prefix"),
           "fp8": ("fal", dict(GREEDY_ECFG, kv_dtype="fp8"), "prefix")}
QUANT_POOL = (12, 4, 4)                 # pages, page size, slots


def _filled(rcfg, rng, num_pages=12, page=4, slots=4):
    """The reference's paged cache filled with a random history."""
    rc = RM.init_paged_cache(rcfg, num_pages, page, slots, "float32")
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), rc)


def _padded_batch(rcfg, rng, C):
    """Three lanes at (pos, n_valid) (5, C), (17, C - 1 or 1), (9, 0: idle)
    over tables of four pages of 4."""
    lanes = ((5, C), (17, max(C - 1, 1)), (9, 0))
    return dict(
        tokens=rng.integers(0, rcfg.vocab, (3, C)).astype(np.int32),
        pos=np.array([p for p, _ in lanes], np.int32),
        n_valid=np.array([n for _, n in lanes], np.int32),
        block_tables=np.arange(1, 25, dtype=np.int32).reshape(3, 8)[:, :6])


def _prefix_workload(vocab, seed=7):
    """A donor parks a 16-token prefix; then its verbatim repeat (a
    full-prompt hit and a copy-on-write), an extension of it, and five
    ~20-token prompts that the 13 usable pages of 4 cannot hold at once
    (preemptions)."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, vocab, 16)
    later = [(1, sysp.copy(), 6, None),
             (2, np.concatenate([sysp, rng.integers(1, vocab, 5)]), 6, None)]
    later += [(3 + i, rng.integers(1, vocab, int(n)), 6, None)
              for i, n in enumerate(rng.integers(16, 24, 5))]
    return [[(0, sysp, 4, None)], later]


def _sampled_workload(vocab, seed=1):
    """Six seeded requests and two greedy ones."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(8):
        samp = None if i >= 6 else dict(temperature=0.8, top_k=50,
                                        top_p=0.95, seed=i)
        reqs.append((i, rng.integers(0, vocab, 4 + i % 7), 6 + 3 * (i % 3),
                     samp))
    return [reqs]


WORKLOADS = {"prefix": _prefix_workload, "sampled": _sampled_workload}


def _ref_engine(rcfg, rparams, ecfg_kw, phases):
    eng = RS.PagedEngine(rcfg, rparams, RS.EngineConfig(**ecfg_kw))
    for reqs in phases:
        for rid, prompt, max_new, samp in reqs:
            eng.submit(RS.ServeRequest(
                rid=rid, prompt=prompt, max_new=max_new,
                sampling=RSP.SamplingParams(**samp) if samp
                else RSP.SamplingParams()))
        eng.run()
    return {r.rid: list(map(int, r.generated)) for r in eng.finished}


def _inputs(cfgs, rng):
    ins = {"packed": {}, "padded": {}, "contiguous": {}, "batcher": {},
           "engines": {}, "quantized": {}, "scatter": {},
           "quant_pool": QUANT_POOL}
    for name, rcfg in cfgs.items():
        batch = _packed_batch(rcfg, rng)
        if rcfg.n_image_tokens:
            batch["image_embeds"] = rng.standard_normal(
                (len(batch["tokens"]), rcfg.d_model)).astype(np.float32)
        ins["packed"][name] = (batch, _filled(rcfg, rng))
    for name, C, dual in PADDED:
        ins["padded"][(name, C, dual)] = (
            _padded_batch(cfgs[name], np.random.default_rng(C), C),
            _filled(cfgs[name], np.random.default_rng(10 + C), 25, slots=3))
    for name, dual in CONTIGUOUS:
        toks = rng.integers(0, cfgs[name].vocab, (BATCH, SEQ)).astype(
            np.int32)
        ins["contiguous"][(name, dual)] = (toks,
                                           [(t, t // 2) for t in range(SEQ)])
    ins["batcher"]["fal"] = (2, 48, [(i, rng.integers(0, 512, 5), 4 + i)
                                     for i in range(5)])
    for key, (name, ecfg_kw, wl) in ENGINES.items():
        ins["engines"][key] = (name, ecfg_kw, WORKLOADS[wl](cfgs[name].vocab))
    for kv in ("int8", "fp8"):
        ins["quantized"][("fal", kv)] = [_packed_batch(cfgs["fal"], rng)]
        shape = (10, cfgs["fal"].n_kv_heads, cfgs["fal"].resolved_head_dim)
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        k[:, 1] *= 4                  # the rows' amax in one rank's head
        ins["scatter"][kv] = (k, v, 5)
    return ins


def _reference(cfgs, weights, ins):
    ref = {}
    for name, (batch, cache) in ins["packed"].items():
        lg, rc = RM.paged_decode_step(
            weights[name], cfgs[name],
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.tree.map(jnp.asarray, cache))
        ref[("packed", name)] = (np.asarray(lg), jax.tree.map(np.asarray, rc))
    step = jax.jit(RM.paged_decode_step, static_argnums=(1, 4))
    for (name, C, dual), (batch, cache) in ins["padded"].items():
        lg, _ = step(weights[name], cfgs[name],
                     {k: jnp.asarray(v) for k, v in batch.items()},
                     jax.tree.map(jnp.asarray, cache),
                     RPlan.single_device("paged", dual_branch=dual))
        ref[("padded", name, C, dual)] = np.asarray(lg)
    dstep = jax.jit(RM.decode_step, static_argnums=(1, 4))
    for (name, dual), (toks, ticks) in ins["contiguous"].items():
        rcfg = cfgs[name]
        rc = RM.init_cache(rcfg, BATCH, SEQ, "float32")
        out = []
        for pos in ticks:
            lg, rc = dstep(weights[name], rcfg, {
                "tokens": jnp.asarray(toks[np.arange(BATCH), list(pos)][:,
                                                                      None]),
                "pos": jnp.asarray(pos, jnp.int32)}, rc,
                RPlan.single_device("decode", dual_branch=dual))
            out.append(np.asarray(lg[:, 0]))
        ref[("contiguous", name, dual)] = np.stack(out)
    for name, (slots, max_seq, reqs) in ins["batcher"].items():
        cb = RD.ContinuousBatcher(cfgs[name], weights[name],
                                  batch_slots=slots, max_seq=max_seq)
        for rid, prompt, max_new in reqs:
            cb.submit(RD.Request(rid=rid, prompt=prompt, max_new=max_new))
        ref[("batcher", name)] = {r.rid: r.generated for r in cb.run()}
    for key, (name, ecfg_kw, phases) in ins["engines"].items():
        ref[("engine", key)] = _ref_engine(cfgs[name], weights[name],
                                           ecfg_kw, phases)
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results and the reference's on the same weights and
    inputs, computed while the ranks run."""
    cfgs = {name: _ref_cfg(**kw) for name, kw in CASES.items()}
    weights = {name: _weights(c, 20 + i)
               for i, (name, c) in enumerate(cfgs.items())}
    ins = _inputs(cfgs, np.random.default_rng(0))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            tp.run_ranks, "torch_tp_serve_ranks:serve", 2, backend="gloo",
            threads=1, timeout=R.RANKS_TIMEOUT,
            workdir=str(tmp_path_factory.mktemp("tp_serving")),
            args=({n: (CASES[n], weights[n]) for n in CASES}, ins))
        jw = {n: jax.tree.map(jnp.asarray, w) for n, w in weights.items()}
        ref = _reference(cfgs, jw, ins)
        return {"ranks": ranks.result(), "ref": ref, "inputs": ins,
                "weights": weights}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


def _ar(counts, kind="all-reduce"):
    return tp.count(counts, kind)


@pytest.mark.parametrize("name", list(CASES))
def test_packed_tick_matches_reference(run, name):
    """Logits of the live rows within 1e-5 on both ranks, bit-equal across
    ranks; each rank's pools are its heads of the reference's; the per-slot
    signal is the reference's (under ``parallel`` the stored row is this
    rank's partial block-0 attention, which no parallel block reads)."""
    want, rc = run["ref"][("packed", name)]
    batch = run["inputs"]["packed"][name][0]
    live = batch["tok_pos"] >= 0
    cfg = R.tp_config(**CASES[name])
    got = [r[("packed", name)] for r in run["ranks"]]
    assert torch.equal(got[0]["logits"], got[1]["logits"])
    for rank, g in enumerate(got):
        _close(g["logits"][0, live], want[0, live])
        heads = SR.kv_heads(cfg, rank, 2)
        for part in ("block0", "blocks"):
            for n in ("k", "v"):
                assert g["cache"][part][n].shape[-2] == heads.stop \
                    - heads.start
                _close(g["cache"][part][n], rc[part][n][..., heads, :])
        if name != "parallel":
            _close(g["cache"]["a1_sig"], rc["a1_sig"])
        assert _ar(g["counts"]) == TICK_ALL_REDUCES[CASES[name][
            "connection"]]
        assert _ar(g["counts"], "all-reduce-max") == 0


@pytest.mark.parametrize("name,C,dual", PADDED)
def test_padded_ticks_match_reference(run, name, C, dual):
    want = run["ref"][("padded", name, C, dual)]
    nv = run["inputs"]["padded"][(name, C, dual)][0]["n_valid"]
    live = np.arange(C)[None] < nv[:, None]
    got = [r[("padded", name, C, dual)] for r in run["ranks"]]
    assert torch.equal(got[0]["logits"], got[1]["logits"])
    for g in got:
        _close(g["logits"][live], want[live])


@pytest.mark.parametrize("name,C", [(m, C) for m in ("fal", "parallel")
                                    for C in (4, 1)])
def test_dual_ticks_equal_sequential_and_pay_the_same(run, name, C):
    """The MHA || MLP block merges its two partials before the one
    all-reduce of the sequential fused block: the same logits of the live
    rows (the same ops on the CPU; an idle lane of a C == 1 dual tick reads
    its cached signal, as on one device) and the same collectives."""
    nv = run["inputs"]["padded"][(name, C, False)][0]["n_valid"]
    live = torch.from_numpy(np.arange(C)[None] < nv[:, None])
    for r in run["ranks"]:
        seq, dual = r[("padded", name, C, False)], r[("padded", name, C,
                                                      True)]
        assert torch.equal(seq["logits"][live], dual["logits"][live])
        assert seq["counts"] == dual["counts"]
        assert _ar(seq["counts"]) == TICK_ALL_REDUCES[name]


@pytest.mark.parametrize("name,dual", CONTIGUOUS)
def test_contiguous_ticks_match_reference(run, name, dual):
    want = run["ref"][("contiguous", name, dual)]
    cfg = R.tp_config(**CASES[name])
    got = [r[("contiguous", name, dual)] for r in run["ranks"]]
    assert torch.equal(got[0]["logits"], got[1]["logits"])
    for g in got:
        _close(g["logits"], want)
        assert g["heads"] == SR.kv_heads(cfg, 0, 2).stop \
            - SR.kv_heads(cfg, 0, 2).start
        assert all(_ar(c) == TICK_ALL_REDUCES[cfg.connection]
                   for c in g["counts"])


def test_batcher_streams_match_reference(run):
    want = run["ref"][("batcher", "fal")]
    for r in run["ranks"]:
        assert r[("batcher", "fal")] == want and len(want) == 5


@pytest.mark.parametrize("key", list(ENGINES))
def test_engine_streams_match_reference(run, key):
    want = run["ref"][("engine", key)]
    got = [r[("engine", key)] for r in run["ranks"]]
    for g in got:
        assert g["streams"] == want
    n = sum(len(reqs) for reqs in run["inputs"]["engines"][key][2])
    assert len(want) == n
    if ENGINES[key][2] == "prefix":
        # the workload's prefix hit, copy-on-write and preemptions happened
        assert got[0]["cow"] > 0 and got[0]["preemptions"] > 0
        assert got[0]["hits"] > 0


@pytest.mark.parametrize("key", list(ENGINES))
def test_ranks_agree_on_packs_and_pay_the_tick_collectives(run, key):
    """Both ranks' engines planned the same packs, tick for tick, and
    each non-speculative call paid L + 1 sum all-reduces (fal) plus, on
    int8 / fp8 pages, L MAX all-reduces of the rows' scales."""
    a, b = (r[("engine", key)] for r in run["ranks"])
    assert a["streams"] == b["streams"]
    assert len(a["packs"]) == len(b["packs"]) > 0
    assert all(np.array_equal(x, y) for x, y in zip(a["packs"], b["packs"]))
    assert a["counts"] == b["counts"]
    if key == "spec":
        return
    n_max = L if "kv_dtype" in ENGINES[key][1] else 0
    for c in a["counts"]:
        assert _ar(c) == L + 1
        assert _ar(c, "all-reduce-max") == n_max
        assert set(c) <= {"all-reduce", "all-reduce-max"}


def _one_device_pools(run, kv):
    cfg = R.tp_config("fal")
    params = interop.params_from_numpy(run["weights"]["fal"], cfg, "cpu",
                                       dtype="float32")
    cache = TM.init_paged_cache(cfg, *QUANT_POOL, "float32", kv_dtype=kv,
                                device="cpu")
    with torch.no_grad():
        for batch in run["inputs"]["quantized"][("fal", kv)]:
            TM.paged_decode_step(params, cfg, {
                k: torch.from_numpy(v) for k, v in batch.items()}, cache)
    return cache


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_pools_gathered_equal_one_device(run, kv):
    one = _one_device_pools(run, kv)
    got = [r[("quantized", "fal", kv)] for r in run["ranks"]]
    for g in got:
        assert _ar(g["counts"], "all-reduce-max") == L
        assert _ar(g["counts"]) == L + 1
    for part in ("block0", "blocks"):
        for n in ("k", "v"):
            gathered = torch.cat([g["cache"][part][n] for g in got], -2)
            np.testing.assert_array_equal(_bytes(gathered),
                                          _bytes(one[part][n]))
        for n in ("k_scale", "v_scale"):
            for g in got:
                if part == "block0":
                    assert torch.equal(g["cache"][part][n], one[part][n])
                else:
                    np.testing.assert_allclose(
                        g["cache"][part][n].numpy(), one[part][n].numpy(),
                        rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_scatter_is_the_one_device_bytes(run, kv):
    """The ranks quantize their heads of the same K / V rows: gathered,
    the codes and the scales are the one-device scatter's exactly, after
    ONE MAX all-reduce; with each rank's own amax (no collective) the
    scales would be other numbers."""
    k, v, pool = run["inputs"]["scatter"][kv]
    cfg = R.tp_config("fal")
    one = TA.gqa_init_paged_cache(cfg, pool, 4, torch.float32, "cpu",
                                  kv_dtype=kv)
    T = k.shape[0]
    tables = (1 + torch.arange(pool - 1, dtype=torch.int32))[None]
    zeros = torch.zeros(T, dtype=torch.int32)
    rows = torch.arange(T, dtype=torch.int32)

    def scatter(pool_, vals):
        return TA.packed_scatter(pool_, vals, tables, zeros, rows, 4)
    TA._scatter_kv(one, torch.from_numpy(k), torch.from_numpy(v), scatter)
    got = [r[("scatter", kv)] for r in run["ranks"]]
    for n in ("k", "v"):
        np.testing.assert_array_equal(
            _bytes(torch.cat([g["cache"][n] for g in got], -2)),
            _bytes(one[n]))
    for g in got:
        assert _ar(g["counts"], "all-reduce-max") == 1
        for n in ("k_scale", "v_scale"):
            assert torch.equal(g["cache"][n], one[n])
    own = TA.gqa_init_paged_cache(cfg, pool, 4, torch.float32, "cpu",
                                  kv_dtype=kv, n_kv_heads=1)
    TA._scatter_kv(own, torch.from_numpy(k[:, :1]),
                   torch.from_numpy(v[:, :1]), scatter)
    assert not torch.equal(own["k_scale"], one["k_scale"])


def test_plans_and_caches_are_per_rank():
    """``init_paged_cache`` / ``init_cache`` hold ``local_kv_heads``; a
    serving plan over a group needs the shard (``_check_shards``)."""
    import types
    cfg = R.tp_config("fal")
    c = TM.init_paged_cache(cfg, 4, 4, 2, "float32", kv_dtype="int8",
                            device="cpu", tp_size=2)
    assert c["blocks"]["k"].shape == (L - 1, 4, 4, 1, 32)
    assert c["blocks"]["k_scale"].shape == (L - 1, 4, 4)
    assert TM.init_cache(cfg, 2, 8, "float32", device="cpu",
                         tp_size=2)["block0"]["v"].shape == (2, 8, 1, 32)
    kv1 = dataclasses.replace(cfg, n_kv_heads=1)
    assert TM.init_cache(kv1, 2, 8, "float32", device="cpu",
                         tp_size=2)["block0"]["k"].shape == (2, 8, 1, 32)
    group = types.SimpleNamespace(size=lambda: 2, rank=lambda: 0)
    plan = TM.ExecutionPlan.from_group(group, tp="explicit")
    full = TM.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="shard_params"):
        TM.serving_plan(full, cfg, plan, "paged")


def test_a_rank_out_of_step_fails_the_spawn_without_hanging(tmp_path):
    """Lockstep is not enforced by a collective of its own: a rank whose
    collectives took another shape fails the spawn (gloo's size check),
    well inside ``run_ranks``' timeout."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed"):
        tp.run_ranks("torch_tp_serve_ranks:drift", 2, backend="gloo",
                     threads=1, timeout=60, workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60
