"""The reference's decode-cache layout in the port (``launch/mesh.py``
``cache_specs``): the KV sequence cut over the data ranks, the model ranks
or both, and the contiguous decode tick's cross-rank softmax combine, on
the CPU against the JAX package.

* (a) For every arch x {decode_32k, long_500k} x {single, multi} mesh that
  applies (the dry run's meshes, ``dryrun.production_mesh``), the port's
  ``cache_specs`` cuts every cache leaf as the reference's
  ``repro.launch.mesh.cache_specs`` does (called with a stand-in mesh: it
  reads only ``axis_names`` and ``shape``, on ``jax.eval_shape`` of the
  reference's ``init_cache``), and a rank's ``init_cache`` holds the
  reference's bytes a rank.
* (b) Reduced configs in fp32 over gloo ranks (``core.tp.run_ranks``, one
  intra-op thread, rank code in ``tests/torch_seq_decode_ranks.py``): two
  ranks as data (batch 1: llama3.2-3b, gemma2-27b's local / global windows
  and softcaps, zamba2-1.2b's shared attention) and as model (one KV head
  at tp 2, and deepseek-v3-671b's MLA, batch 2); four ranks as tp 2 x dp 2
  (the sequence over both for one KV head, MLA and gemma2 at batch 1; MLA
  at batch 2, rows over data and the latent over model; llama3.2-3b at
  batch 1, heads over model and the sequence over data).  Every rank's
  greedy stream over 13 or 16 ticks against the reference's
  single-device ``decode_step``: tokens equal, logits within ``TOL``
  (``test_torch_tp_serving.py``'s), ranks that serve the same rows bit
  for bit equal.  The ticks include positions whose keys lie all in
  another rank's slice (later ranks fully masked: future keys; earlier
  ones: outside gemma2's window) and positions past S (the write clamps to
  row S - 1, as ``dynamic_update_slice`` does).  Each tick's ``seq``
  collectives are counted exactly, and each rank's cache holds the dry
  run's bytes (``specs.decode_input_specs``).
* (c) ``ContinuousBatcher`` over a data group (and over tp 2 x dp 2) with
  the sequence cut serves each request as the reference's one-device
  batcher does, and ``make_prefill_then_decode`` over a data group gives
  the reference's tokens.
"""
import concurrent.futures
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.core.plan import ExecutionPlan as RPlan  # noqa: E402
from repro.launch import mesh as RMX  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import decode as RD  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import decode as TD  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
from test_torch_tp import _ref_cfg, _weights  # noqa: E402

TOL = 1e-5
DECODE_SHAPES = ("decode_32k", "long_500k")


# --------------------------------------------------------------------------- #
# (a) cache_specs against the reference's
# --------------------------------------------------------------------------- #
def _stand_in(mesh):
    """A mesh the reference's ``cache_specs`` can read: the port's mesh's
    axes (pod only when it has two)."""
    shape = {"pod": mesh.pod, "data": mesh.data, "model": mesh.model}
    names = ("pod", "data", "model") if mesh.pod > 1 else ("data", "model")
    return types.SimpleNamespace(axis_names=names,
                                 shape={a: shape[a] for a in names})


def _port_axes(entry):
    """A reference spec entry -> the port's axes tuple: the data axes
    (pod, data) are the port's one ``data`` axis."""
    if entry is None:
        return ()
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    out = []
    for a in names:
        a = MX.DATA if a in ("pod", "data") else MX.MODEL
        if a not in out:
            out.append(a)
    return tuple(out)


def _leaves_with_keys(tree, key=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_keys(v, k)
    else:
        yield key, tree


@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_cache_specs_match_reference(arch):
    tcfg = TB.get_config(arch)
    rcfg = ref_config(arch)
    ran = 0
    for shape in DECODE_SHAPES:
        shape_cfg = TB.INPUT_SHAPES[shape]
        if not TB.shape_applicable(tcfg, shape_cfg)[0]:
            continue
        B, S = shape_cfg.global_batch, shape_cfg.seq_len
        rcache = jax.eval_shape(lambda: RM.init_cache(rcfg, B, S, "bfloat16"))
        for kind in ("single", "multi"):
            mesh = DR.production_mesh(kind, tcfg)
            tp_size, dp = mesh.model, mesh.pod * mesh.data
            stand = _stand_in(mesh)
            rspecs = RMX.cache_specs(rcfg, stand, B)(rcache)
            ours = MX.cache_specs(tcfg, tp_size, dp, B)
            want = 0
            for (key, leaf), (_, spec) in zip(
                    _leaves_with_keys(rcache), _leaves_with_keys(
                        rspecs)):
                ref = [_port_axes(e) for e in spec]
                lead = len(ref) - len(ours[key])
                assert ref[:lead] == [()] * lead, (key, spec)
                assert tuple(ref[lead:]) == ours[key], (shape, kind, key)
                n = 1
                for d, e in zip(leaf.shape, spec):
                    parts = 1
                    for a in ((e,) if isinstance(e, str) else (e or ())):
                        parts *= stand.shape[a]
                    assert d % parts == 0
                    n *= d // parts
                want += n * leaf.dtype.itemsize
            cache = TM.init_cache(tcfg, B, S, "bfloat16", device="meta",
                                  tp_size=tp_size, dp_size=dp)
            got = sum(t.numel() * t.element_size()
                      for _, t in _leaves_with_keys(cache))
            assert got == want, (shape, kind, got, want)
            ran += 1
    assert ran


# --------------------------------------------------------------------------- #
# (b) decode over sequence-cut caches, (c) the batcher and prefill
# --------------------------------------------------------------------------- #
KW = {"llama": dict(connection="fal"),
      "kv1": dict(connection="fal", n_kv_heads=1),
      "gemma2": dict(connection="fal", arch="gemma2-27b"),
      "gemma2_kv1": dict(connection="fal", arch="gemma2-27b", n_kv_heads=1),
      "zamba": dict(connection="fal", arch="zamba2-1.2b"),
      "mla": dict(connection="fal", arch="deepseek-v3-671b")}
#: positions a tick over S = 16: the first ticks' keys all lie in the
#: first quarter (every later rank fully masked), 16 and 17 clamp to row
#: 15 (every key visible)
POS16 = (2, 3, 4, 5, 9, 10, 11, 12, 13, 14, 15, 16, 17)
#: over S = 128 (gemma2, window 64 on its local layers): early positions
#: mask every later rank (future keys), late ones every earlier rank
#: outside the window on the local layers; 128 and 129 clamp
POS128 = (20, 21, 22, 23) + tuple(range(118, 128)) + (128, 129)
#: (model, B, S, positions): the reference streams, one per distinct
#: (config, batch)
STREAMS = {("llama", 1): (16, POS16), ("gemma2", 1): (128, POS128),
           ("zamba", 1): (16, POS16), ("kv1", 2): (16, POS16),
           ("mla", 2): (16, POS16), ("kv1", 1): (16, POS16),
           ("mla", 1): (16, POS16), ("gemma2_kv1", 1): (128, POS128)}
#: spawn -> {case: (model, B, role, the axes the sequence is cut over)};
#: the two-rank world takes the case's role, the four ranks are tp 2 x dp 2
SPAWNS = {
    2: {"llama_data": ("llama", 1, "data", ("data",)),
        "gemma2_data": ("gemma2", 1, "data", ("data",)),
        "zamba_data": ("zamba", 1, "data", ("data",)),
        "kv1_model": ("kv1", 2, "model", ("model",)),
        "mla_model": ("mla", 2, "model", ("model",))},
    4: {"kv1_both": ("kv1", 1, None, ("data", "model")),
        "mla_both": ("mla", 1, None, ("data", "model")),
        "gemma2_both": ("gemma2_kv1", 1, None, ("data", "model")),
        "mla_rows": ("mla", 2, None, ("model",)),
        "llama_heads": ("llama", 1, None, ("data",))}}
BATCHERS = {2: {"data": ("llama", "data")}, 4: {"both": ("kv1", None)}}
BATCHER_SLOTS, BATCHER_SEQ = 3, 32
GEN = dict(model="llama", B=1, S=16, prompt=6, max_new=6)


def _ticks(B, positions):
    """(T, B) int32: lane b three positions behind lane 0 (ragged)."""
    p = np.asarray(positions, np.int32)[:, None] - 3 * np.arange(B)[None]
    return np.maximum(p, 0).astype(np.int32)


def _filled(rcfg, B, S, rng):
    """The reference's contiguous cache filled with a random history."""
    rc = jax.eval_shape(lambda: RM.init_cache(rcfg, B, S, "float32"))
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.dtype(a.dtype)), rc)


def _ref_stream(rcfg, w, cache, tok0, ticks):
    """The reference's single-device greedy ticks -> (logits (T, B, V),
    tokens (T, B))."""
    step = jax.jit(RM.decode_step, static_argnums=(1, 4))
    rc = jax.tree.map(jnp.asarray, cache)
    tok, logits, toks = tok0, [], []
    for pos in ticks:
        lg, rc = step(w, rcfg, {"tokens": jnp.asarray(tok[:, None]),
                                "pos": jnp.asarray(pos)}, rc,
                      RPlan.single_device("decode"))
        lg = np.asarray(lg[:, 0])
        tok = lg.argmax(-1).astype(np.int32)
        logits.append(lg)
        toks.append(tok)
    return np.stack(logits), np.stack(toks)


def _requests(vocab, rng):
    return [(i, rng.integers(0, vocab, 5).astype(np.int32), 4 + i)
            for i in range(5)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both spawns' results and the reference's on the same weights,
    caches and requests, computed while the ranks run."""
    rng = np.random.default_rng(0)
    rcfgs = {m: _ref_cfg(**kw) for m, kw in KW.items()}
    weights = {m: _weights(c, 30 + i) for i, (m, c) in enumerate(
        rcfgs.items())}
    streams = {}
    for (m, B), (S, pos) in STREAMS.items():
        streams[(m, B)] = dict(
            S=S, ticks=_ticks(B, pos), cache=_filled(rcfgs[m], B, S, rng),
            tok0=rng.integers(0, rcfgs[m].vocab, B).astype(np.int32))
    reqs = {m: _requests(rcfgs[m].vocab, rng) for m in ("llama", "kv1")}
    prompts = rng.integers(0, rcfgs["llama"].vocab,
                           (GEN["B"], GEN["prompt"])).astype(np.int32)
    spawn_args = {}
    for world, cases in SPAWNS.items():
        dec = {}
        for name, (m, B, role, _) in cases.items():
            st = streams[(m, B)]
            dec[name] = dict(kw=KW[m], weights=weights[m], B=B, S=st["S"],
                             role=role, cache=st["cache"], tok0=st["tok0"],
                             ticks=st["ticks"])
        bat = {k: dict(kw=KW[m], weights=weights[m], role=role,
                       B=BATCHER_SLOTS, S=BATCHER_SEQ, reqs=reqs[m])
               for k, (m, role) in BATCHERS[world].items()}
        gens = {} if world == 4 else {"data": dict(
            kw=KW[GEN["model"]], weights=weights[GEN["model"]], role="data",
            B=GEN["B"], S=GEN["S"], prompts=prompts,
            max_new=GEN["max_new"])}
        spawn_args[world] = (dec, bat, gens)

    def spawns():
        return {world: tp.run_ranks(
            "torch_seq_decode_ranks:run", world, backend="gloo", threads=1,
            timeout=R.RANKS_TIMEOUT, tp_size=2 if world == 4 else None,
            workdir=str(tmp_path_factory.mktemp(f"seq_decode_{world}")),
            args=spawn_args[world]) for world in SPAWNS}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawns)
        jw = {m: jax.tree.map(jnp.asarray, w) for m, w in weights.items()}
        ref = {key: _ref_stream(rcfgs[key[0]], jw[key[0]], st["cache"],
                                st["tok0"], st["ticks"])
               for key, st in streams.items()}
        ref_batch = {}
        for m, rq in reqs.items():
            cb = RD.ContinuousBatcher(rcfgs[m], jw[m],
                                      batch_slots=BATCHER_SLOTS,
                                      max_seq=BATCHER_SEQ)
            for rid, prompt, max_new in rq:
                cb.submit(RD.Request(rid=rid, prompt=prompt,
                                     max_new=max_new))
            ref_batch[m] = {r.rid: r.generated for r in cb.run()}
        gm = GEN["model"]
        ref_gen, _ = RD.make_prefill_then_decode(rcfgs[gm])(
            jw[gm], prompts, GEN["max_new"],
            RM.init_cache(rcfgs[gm], GEN["B"], GEN["S"], "float32"))
        return {"ranks": ranks.result(), "ref": ref, "batch": ref_batch,
                "gen": np.asarray(ref_gen), "streams": streams}


CASES = [(world, name) for world, cases in SPAWNS.items() for name in cases]


def _attention_layers(cfg):
    """Attention caches a tick reads: one a layer, or one a zamba group."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


@pytest.mark.parametrize("world,name", CASES)
def test_sequence_cut_decode_matches_reference(run, world, name):
    """Every rank's greedy stream and logits against the reference's one
    device; ranks serving the same rows bit for bit equal; the layout,
    the ``seq`` collectives a tick and the cache bytes a rank."""
    m, B, _, axes = SPAWNS[world][name]
    want_logits, want_tokens = run["ref"][(m, B)]
    cfg = R.tp_config(**KW[m])
    got = [r["decode"][name] for r in run["ranks"][world]]
    n = _attention_layers(cfg)
    by_rows = {}
    for g in got:
        lo, hi = g["rows"]
        assert g["seq_axes"] == axes
        np.testing.assert_array_equal(g["tokens"].numpy(),
                                      want_tokens[:, lo:hi])
        np.testing.assert_allclose(g["logits"].numpy(),
                                   want_logits[:, lo:hi], atol=TOL, rtol=0)
        by_rows.setdefault((lo, hi), []).append(g["logits"])
        for c in g["counts"]:
            assert tp.count(c, "all-reduce-max", "seq") == n * len(axes)
            assert tp.count(c, "all-reduce", "seq") == n * len(axes)
            assert tp.count(c, "all-gather", "seq") == (
                n if "model" in axes else 0)
    for same in by_rows.values():
        for lg in same[1:]:
            assert torch.equal(lg, same[0])
    # every rank's slice has the dry run's bytes at its mesh
    tsize = 2 if world == 4 or SPAWNS[world][name][2] == "model" else 1
    dsize = world // tsize
    S = run["streams"][(m, B)]["S"]
    cache = SP.decode_input_specs(
        cfg, TB.ShapeConfig("t", S, B, "decode"), tsize, dsize,
        cache_dtype="float32")[1]
    want = sum(t.numel() * t.element_size()
               for _, t in _leaves_with_keys(cache))
    assert all(g["cache_bytes"] == want for g in got)
    # the positions of every part were covered once
    parts = sorted({g["positions"] for g in got})
    assert parts[0][0] == 0 and parts[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))


@pytest.mark.parametrize("world", list(BATCHERS))
def test_batcher_over_a_sequence_cut_serves_as_one_device(run, world):
    for key, (m, _) in BATCHERS[world].items():
        want = run["batch"][m]
        assert len(want) == 5
        for r in run["ranks"][world]:
            streams, axes = r["batcher"][key]
            assert streams == want
            assert "data" in axes


def test_prefill_then_decode_over_a_data_group(run):
    """Each rank keeps the prompt's K / V at its own positions: the
    generated tokens are the reference's."""
    for r in run["ranks"][2]:
        np.testing.assert_array_equal(r["generate"]["data"], run["gen"])


def test_batcher_refuses_a_data_group_whose_rows_divide():
    group = types.SimpleNamespace(size=lambda: 2, rank=lambda: 0)
    cfg = R.tp_config("fal")
    plan = TM.ExecutionPlan.from_group(None, tp="none", data_group=group)
    params = TM.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        TD.ContinuousBatcher(cfg, params, 2, 16, plan=plan, device="cpu")


def test_paged_and_unfitting_layouts_raise():
    """A paged tick refuses a sequence-cut layout; a cache whose sequence
    its ranks do not divide raises (no padding); a data group in decode
    without a sequence cut or FSDP raises."""
    group = types.SimpleNamespace(size=lambda: 2, rank=lambda: 0)
    cfg = R.tp_config("fal")
    params = TM.init_params(cfg, seed=0, device="cpu")
    plan = TM.ExecutionPlan.from_group(None, tp="none", data_group=group)
    with pytest.raises(ValueError, match="paged"):
        TM.serving_plan(params, cfg, plan.with_cache_layout(cfg, 1), "paged")
    with pytest.raises(ValueError, match="data-parallel"):
        TM.serving_plan(params, cfg, plan.with_cache_layout(cfg, 2),
                        "decode")
    with pytest.raises(ValueError, match="not padded"):
        TM.init_cache(cfg, 1, 15, "float32", device="cpu", dp_size=2)
    assert MX.rank_slice(cfg, 1, 2, 1, 16, 0, 1) == {"rows": (0, 1),
                                                      "positions": (8, 16)}
