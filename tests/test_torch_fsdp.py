"""FSDP (ZeRO-3 over the data group) in the port against the JAX package, on
the CPU.

* Layout: for every arch, each leaf's FSDP dim in the port
  (``launch.mesh.fsdp_specs``) equals the data-sharded dim of the
  reference's ``param_specs(..., fsdp_axes=("data",))`` on
  ``jax.eval_shape`` of its ``init_state``, for params, ``m`` and ``v``,
  with and without ``kv_replicated``.
* Numerics: gloo ranks (``core.tp.run_ranks`` with ``tp_size``) train the
  reduced llama3.2-3b at 4 layers (fal, fp32) on the reference's weights
  drawn with numpy, at dp 2 and at tp 2 x dp 2, with 1 and 2 microbatches,
  remat on and off, plus one reduced MoE (qwen3-moe) and one reduced MLA +
  MTP (deepseek-v3, its ``q_lora_rank`` 49 an uneven dim) case at dp 2.
  The reduced widths reach no dim of 1024, so the floor is lowered to
  ``FLOOR`` in both packages; every block matmul weight is then sliced.
  3 AdamW steps follow the reference's one-device ``make_train_step`` under
  ``test_torch_dp.py``'s gates (loss 1e-5, ``grad_norm`` 1e-5 relative,
  params 1e-6 plus 1e-4 of each leaf's largest value); the padding rows of
  a slice stay zero.
* Collectives per step, exactly: one all-gather a unit a pass (two under
  remat), one reduce-scatter a unit a microbatch, and the flat data
  all-reduce over the leaves FSDP leaves whole only.
* Checkpoints: the reference's ``checkpoint.restore`` reads the gathered
  state; ``restore_sharded`` gives back each rank's slices bit for bit.
* Serving: prefill logits and contiguous ``make_serve_step`` ticks within
  1e-5 of one device, greedy tokens equal; the trainer follows the
  one-device trainer of the seed; the expert-parallel MoE FFN takes FSDP
  slices of its experts.

Each world is spawned once, one after the other, while the reference runs
in the test process.
"""
import concurrent.futures

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.launch import mesh as RMX  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro.train import step as RT  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.interop import STACKED  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.blocks import is_moe  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
from test_torch_dryrun import TRAIN, _ref_leaves, _ref_state  # noqa: E402
from test_torch_tp import _ref_cfg, _weights  # noqa: E402
from test_torch_train import _close_tree  # noqa: E402

OCFG = dict(lr=3e-4, weight_decay=0.5, clip_norm=0.05)
STEPS, B, S = 3, 4, 16
#: the FSDP floor of the reduced configs (``FSDP_MIN_DIM`` is 1024)
FLOOR = 32
#: (world size, tp size)
LAYOUTS = {"dp2": (2, 1), "dp2xtp2": (4, 2)}
LLAMA_RUNS = [(nm, remat) for nm in (1, 2) for remat in (False, True)]
#: name -> (config kwargs of ``tp_config`` / ``_ref_cfg``, worlds, runs).
#: A MoE layer's load-balance aux is not linear in the batch: each data
#: rank's is its rows' (the reference's pmean over the data axes), so the
#: MoE cases' reference is the one-device step with each data rank's rows
#: as a microbatch (``REF_MICROBATCHES``), whose aux is those rows' too
CASES = {"llama": (dict(connection="fal"), tuple(LAYOUTS), LLAMA_RUNS),
         "moe": (dict(connection="fal", arch="qwen3-moe-30b-a3b"), ("dp2",),
                 [(1, False)]),
         "mla": (dict(connection="fal", arch="deepseek-v3-671b",
                      q_lora_rank=49), ("dp2",), [(1, False)]),
         "mamba": (dict(connection="fal", arch="mamba2-370m"), ("dp2",),
                   [(1, False)]),
         "zamba": (dict(connection="fal", arch="zamba2-1.2b"), ("dp2",),
                   [(1, False), (1, True)]),
         "whisper": (dict(connection="fal", arch="whisper-small"), ("dp2",),
                     [(1, False)])}
#: the cases of the decoder family, whose units the count test knows
DECODER = ("llama", "moe", "mla")
#: cases also run without FSDP (plain data parallelism), whose params the
#: FSDP run's must equal.  zamba's are held against those instead of the
#: reference's: its plain data-parallel run leaves the one-device params'
#: gate on ``embed`` by about 2x, an Adam step over a gradient that is
#: rounding noise there (ROADMAP.md Queue 3)
WITH_DP = ("mamba", "zamba", "whisper")
AGAINST_DP = ("zamba",)
REF_MICROBATCHES = {"llama": 1, "moe": 2, "mla": 2, "mamba": 1, "zamba": 1,
                    "whisper": 1}
TRAINER_KW = dict(steps=2, batch=B, seq_len=S, seed=0)
SERVE_TICKS = 4


# ------------------------------------------------------------------ layout --
def _ref_path(path, cfg, block):
    """A port leaf's path in the reference's tree and its stack depth."""
    if cfg.family in STACKED:
        depth = STACKED[cfg.family].get(path[0], 0)
        return (path[0],) + path[1 + depth:], depth
    if path[0] == "blocks":
        stack = "blocks_moe" if is_moe(block) else "blocks_dense"
        return (stack,) + path[2:], 1
    return path, 0


def _ref_fsdp_dims(tree, rcfg, kv_rep):
    """{reference path: data-sharded dim less the stack axes' count}."""
    specs = jax.tree_util.tree_leaves(
        RMX.param_specs(tree, rcfg, fsdp_axes=("data",),
                        kv_replicated=kv_rep),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    out = {}
    for (path, _), spec in zip(_ref_leaves(tree), specs):
        spec = tuple(spec)
        out[path] = spec.index("data") if "data" in spec else None
    return out


def _assert_layout(port_tree, ref_tree, cfg, rcfg, tp_size, dp_size, kv_rep):
    ref = _ref_fsdp_dims(ref_tree, rcfg, kv_rep)
    port = MX.fsdp_specs(port_tree, cfg, tp_size, dp_size,
                         kv_replicated=kv_rep)
    blocks = port_tree.get("blocks", [])
    n = 0
    for path, dim in named_leaves(port):
        block = blocks[path[1]] if path[0] == "blocks" and blocks and \
            isinstance(path[1], int) else None
        rpath, depth = _ref_path(path, cfg, block)
        want = ref[rpath]
        assert dim == (None if want is None else want - depth), (path, dim,
                                                                 want)
        n += dim is not None
    return n


@pytest.mark.parametrize("kv_rep", [False, True])
@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_fsdp_layout_matches_reference(arch, kv_rep):
    rcfg, rst = _ref_state(arch)
    cfg = SP.dryrun_overrides(TB.get_config(arch), TRAIN)
    state, _ = SP.train_input_specs(cfg, TRAIN)
    for key in ("params", "m", "v"):
        port = state["params"] if key == "params" else state["opt"][key]
        ref = rst["params"] if key == "params" else rst["opt"][key]
        n = _assert_layout(port, ref, cfg, rcfg, 8, 32, kv_rep)
        if arch != "whisper-small" and arch != "gpt2-117m":
            assert n > 0, arch           # d >= 1024: something is sliced


def test_fsdp_layout_one_data_rank_slices_nothing():
    cfg = TB.get_config("llama3.2-3b")
    assert MX.fsdp_layout(cfg, 8, 1) == {}
    assert MX.fsdp_layout(cfg, 8, 32)


@pytest.mark.parametrize("n,dp", [(4384, 256), (64, 2), (49, 2), (7, 3)])
def test_fsdp_slice_pads_the_last_rank(n, dp):
    """Every rank holds ceil(n / dp) rows, the last ones zero-padded, and
    the slices joined give the leaf back."""
    t = torch.arange(3 * n, dtype=torch.float32).reshape(3, n) + 1
    parts = [MX.fsdp_slice(t, 1, r, dp) for r in range(dp)]
    k = -(-n // dp)
    assert all(p.shape == (3, k) for p in parts)
    joined = torch.cat(parts, 1)
    assert torch.equal(joined[:, :n], t)
    assert (joined[:, n:] == 0).all()


# --------------------------------------------------------------- the runs --
def _extra(name, kw):
    """Each step's global inputs beside the tokens: whisper's frames."""
    if name != "whisper":
        return None
    cfg = _ref_cfg(**kw)
    return {"frames": np.random.default_rng(3).standard_normal(
        (STEPS + 1, B, cfg.n_enc_frames, cfg.d_model)).astype(np.float32)}


def _reference(kw, weights, toks, nm, extra):
    cfg = _ref_cfg(**kw)
    ocfg = RO.AdamWConfig(**OCFG)
    step = jax.jit(RT.make_train_step(cfg, ocfg, num_microbatches=nm))
    state = {"params": weights, "opt": RO.init_opt_state(weights, ocfg)}
    metrics = []
    for i, t in enumerate(toks[:STEPS]):
        batch = {"tokens": jnp.asarray(t),
                 **{k: jnp.asarray(v[i]) for k, v in (extra or {}).items()}}
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state["params"]), metrics


def _ref_prefill(weights, toks):
    cfg = _ref_cfg("fal")
    logits, _, _ = RM.forward(weights, cfg, {"tokens": jnp.asarray(toks)},
                              "prefill")
    return np.asarray(logits)


def _ep_inputs(weights, cfg):
    """A MoE layer's FFN (the reference's first ``blocks_moe`` layer) and
    (dp, ep, b, s, d) token shards."""
    ffn = {k: np.asarray(v[0]) for k, v in
           weights["blocks_moe"]["ffn"].items()}
    x = np.random.default_rng(7).standard_normal(
        (2, 2, 1, 8, cfg.d_model)).astype(np.float32)
    return ffn, x


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights = {name: _weights(_ref_cfg(**kw), 0)
               for name, (kw, _, _) in CASES.items()}
    extra = {name: _extra(name, kw) for name, (kw, _, _) in CASES.items()}
    toks = np.random.default_rng(1).integers(
        0, 512, (STEPS + 1, B, S)).astype(np.int32)
    serve_toks = np.random.default_rng(2).integers(
        0, 512, (B, 8)).astype(np.int32)
    moe_cfg = _ref_cfg(**CASES["moe"][0])
    ckpts = {name: str(tmp_path_factory.mktemp(f"fsdp_ckpt_{name}"))
             for name in LAYOUTS}

    def spawn_all():
        out = {}
        for name, (world, tp_size) in LAYOUTS.items():
            cases = [(c, kw, weights[c], r, extra[c]) for c, (kw, worlds, r)
                     in CASES.items() if name in worlds]
            ep = (CASES["moe"][0], *_ep_inputs(weights["moe"], moe_cfg)) \
                if tp_size == 2 else None
            out[name] = tp.run_ranks(
                "torch_fsdp_ranks:fsdp_world", world, backend="gloo",
                threads=1, timeout=R.RANKS_TIMEOUT, tp_size=tp_size,
                workdir=str(tmp_path_factory.mktemp(f"fsdp_{name}")),
                args=(cases, toks, OCFG, FLOOR, ckpts[name],
                      (dict(connection="fal"), weights["llama"], serve_toks,
                       SERVE_TICKS), TRAINER_KW, ep, WITH_DP))
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_all)
        ref = {name: _reference(kw, weights[name], toks,
                                REF_MICROBATCHES[name], extra[name])
               for name, (kw, _, _) in CASES.items()}
        prefill = _ref_prefill(weights["llama"], serve_toks)
        _, one = trainer.train(R.tp_config("fal"), device="cpu",
                               log_every=1, **TRAINER_KW)
        return {"ranks": ranks.result(), "ref": ref, "weights": weights,
                "prefill": prefill, "ckpts": ckpts,
                "one_device_trainer": [(h["loss"], h["grad_norm"])
                                       for h in one]}


@pytest.fixture
def floor(monkeypatch):
    """The reduced configs' floor in both packages."""
    monkeypatch.setattr(MX, "FSDP_MIN_DIM", FLOOR)
    monkeypatch.setattr(RMX, "_FSDP_MIN_DIM", FLOOR)


RUN_CASES = [(world, name, nm, remat) for name, (_, worlds, rs) in
             CASES.items() for world in worlds for nm, remat in rs]
DECODER_RUNS = [c for c in RUN_CASES if c[1] in DECODER]
DP_RUNS = [c for c in RUN_CASES if c[1] in WITH_DP]


def _whole(ranks, cfg, get):
    """The one-device tree from every rank's slices: each TP rank's data
    ranks joined (``gather_fsdp``), then the TP ranks
    (``gather_params``)."""
    tp_size = ranks[0]["tp_size"]
    by_tp = []
    for t in range(tp_size):
        mine = sorted((r for r in ranks if r["tp_rank"] == t),
                      key=lambda r: r["dp_rank"])
        by_tp.append(MX.gather_fsdp([get(r) for r in mine], cfg, tp_size))
    return MX.gather_params(by_tp, cfg) if tp_size > 1 else by_tp[0]


@pytest.mark.parametrize("name", CASES)
def test_reduced_layout_slices_every_block_matmul(floor, name):
    """At the lowered floor the port's layout still equals the reference's,
    every block matmul weight is sliced, and the MLA case holds an uneven
    dim (``q_lora_rank`` 49 over 2 ranks)."""
    kw = CASES[name][0]
    cfg, rcfg = R.tp_config(**kw), _ref_cfg(**kw)
    rparams = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                             jax.random.PRNGKey(0))
    port = TM.init_params(cfg, device="meta", dtype="float32")
    for tp_size in (1, 2):
        _assert_layout(port, rparams, cfg, rcfg, tp_size, 2, False)
        layout = MX.fsdp_layout(cfg, tp_size, 2)
        for path, t in named_leaves(port):
            if path[0].startswith("block") and t.dim() >= 2 \
                    and path[-1] != "conv_w":    # mamba's conv, never sliced
                assert path in layout, path
        uneven = [p for p, (_, n) in layout.items() if n % 2]
        assert bool(uneven) == (name == "mla"), uneven


@pytest.mark.parametrize("world,name,nm,remat", RUN_CASES)
def test_fsdp_losses_and_norms_match_reference(runs, world, name, nm, remat):
    _, ref_metrics = runs["ref"][name]
    assert ref_metrics[0]["grad_norm"] > OCFG["clip_norm"]
    for r in runs["ranks"][world]:
        for got, want in zip(r[(name, nm, remat)]["metrics"], ref_metrics):
            assert abs(got["loss"] - want["loss"]) <= 1e-5, (got, want)
            assert abs(got["grad_norm"] - want["grad_norm"]) \
                <= 1e-5 * want["grad_norm"], (got, want)


@pytest.mark.parametrize("world,name,nm,remat",
                         [c for c in RUN_CASES if c[1] not in AGAINST_DP])
def test_fsdp_params_match_reference(runs, floor, world, name, nm, remat):
    ref_params, _ = runs["ref"][name]
    ranks = runs["ranks"][world]
    cfg = R.tp_config(remat=remat, **CASES[name][0])
    res = [dict(r, run=r[(name, nm, remat)]) for r in ranks]
    _close_tree(ref_params, _whole(res, cfg, lambda r: r["run"]["params"]),
                cfg, 1e-6, 1e-4)
    for r in res:
        ok, padded = r["run"]["pad"]
        assert ok, r["rank"]
        # the last data rank pads w_uq's 49 rows: its params, m and v
        assert padded == (3 * cfg.n_layers + 3 if name == "mla"
                          and r["dp_rank"] == 1 else 0), (r["rank"], padded)


@pytest.mark.parametrize("world,name,nm,remat", DP_RUNS)
def test_fsdp_params_match_data_parallel(runs, floor, world, name, nm, remat):
    """The ssm, hybrid and audio stacks under FSDP against the same world
    without it, under the same gate; and every padding row stays zero."""
    cfg = R.tp_config(remat=remat, **CASES[name][0])
    res = [dict(r, run=r[(name, nm, remat)]) for r in runs["ranks"][world]]
    got = dict(named_leaves(_whole(res, cfg, lambda r: r["run"]["params"])))
    want = dict(named_leaves(res[0]["run"]["dp"]))
    assert got.keys() == want.keys()
    for path, w in want.items():
        tol = 1e-6 + 1e-4 * float(w.abs().max())
        assert float((got[path] - w).abs().max()) <= tol, path
    assert all(r["run"]["pad"][0] for r in res)


@pytest.mark.parametrize("world,name,nm,remat", DECODER_RUNS)
def test_fsdp_collectives_per_step(runs, floor, world, name, nm, remat):
    """One all-gather a unit a pass (its recompute gathers again under
    remat), one reduce-scatter a unit a microbatch, of exactly the slices'
    bytes; one flat data all-reduce of the leaves FSDP leaves whole."""
    cfg = R.tp_config(remat=remat, **CASES[name][0])
    for r in runs["ranks"][world]:
        run, dp = r[(name, nm, remat)], r["dp_size"]
        layout = MX.fsdp_layout(cfg, r["tp_size"], dp)
        leaves = dict(named_leaves(run["params"]))
        whole = sum(t.numel() for p, t in leaves.items() if p not in layout)
        # the head unit runs in the CE tail and again in the MTP loss
        uses = {"head": 1 + bool(cfg.mtp_depth)}
        units = cfg.n_layers + bool(cfg.mtp_depth) \
            + (0 if cfg.tie_embeddings else uses["head"])
        sliced = sum(t.numel() * uses.get(p[0], 1)
                     for p, t in leaves.items() if p in layout)
        passes = nm * (2 if remat else 1)
        for c in run["counts"]:
            assert tp.count(c, "all-gather", "fsdp") == units * passes, c
            assert tp.count(c, "all-gather", "fsdp", "bytes") == \
                4 * dp * sliced * passes, c
            assert tp.count(c, "reduce-scatter", "fsdp") == units * nm, c
            assert tp.count(c, "reduce-scatter", "fsdp", "bytes") == \
                4 * sliced * nm, c
            assert tp.count(c, "all-reduce", "data") == 1, c
            assert tp.count(c, "all-reduce", "data", "bytes") == 4 * whole
            assert tp.count(c, "all-reduce", "metric") == 1, c
            # the norm's data sum, and under TP the gradient and norm sums
            assert tp.count(c, "all-reduce", "step") == \
                (3 if r["tp_size"] > 1 else 1), c


def test_fsdp_moe_and_mla_runs_slice_their_leaves(runs, floor):
    """The MoE and MLA + MTP cases slice the experts, the routers and the
    MLA down-projections."""
    for name, keys in (("moe", ("router", "wi", "wg", "wo")),
                       ("mla", ("w_dq", "w_dkv", "w_kr", "w_uq"))):
        cfg = R.tp_config(**CASES[name][0])
        layout = MX.fsdp_layout(cfg, 1, 2)
        got = {p[-1] for p in layout}
        assert set(keys) <= got, (name, got)
    mla = R.tp_config(**CASES["mla"][0])
    assert any(p[0] == "mtp" for p in MX.fsdp_layout(mla, 1, 2))
    assert ("head", "w") in MX.fsdp_layout(mla, 1, 2)


@pytest.mark.parametrize("world", LAYOUTS)
def test_fsdp_checkpoint_reference_restores_gathered_state(runs, floor,
                                                           world):
    ranks = runs["ranks"][world]
    weights = runs["weights"]["llama"]
    like = {"params": weights,
            "opt": RO.init_opt_state(weights, RO.AdamWConfig(**OCFG))}
    got = RC.restore(runs["ckpts"][world], like)
    cfg = R.tp_config("fal")
    for key in ("params", "m", "v"):
        tree = _whole(ranks, cfg, lambda r: r["ckpt"]["state"]["params"]
                      if key == "params" else r["ckpt"]["state"]["opt"][key])
        want = got["params"] if key == "params" else got["opt"][key]
        _close_tree(jax.tree.map(np.asarray, want), tree, cfg, 0.0)
    assert int(got["opt"]["count"]) == STEPS
    layout = MX.fsdp_layout(cfg, ranks[0]["tp_size"], 2)
    for r in ranks:
        assert r["ckpt"]["restored_equal"] and r["ckpt"]["requires_grad"]
        assert r["ckpt"]["step_equal"], r["rank"]
        c = r["ckpt"]["counts"]
        assert tp.count(c, "all-gather", "checkpoint") >= 3 * len(layout)


@pytest.mark.parametrize("world", LAYOUTS)
def test_fsdp_prefill_and_decode_match_one_device(runs, world):
    ref = runs["prefill"]
    n_units = R.tp_config("fal").n_layers
    for r in runs["ranks"][world]:
        s = r["serve"]
        rows = ref.reshape((2, -1) + ref.shape[1:])[r["dp_rank"]]
        assert (s["prefill"] - s["prefill_one"]).abs().max() <= 1e-5
        np.testing.assert_allclose(s["prefill"].numpy(), rows, atol=1e-5)
        assert torch.equal(s["prefill"].argmax(-1),
                           s["prefill_one"].argmax(-1))
        assert tp.count(s["prefill_counts"], "all-gather", "fsdp") == n_units
        dec, one = s["decode"], s["decode_one"]
        assert (dec["logits"] - one["logits"]).abs().max() <= 1e-5
        assert torch.equal(dec["next"], one["next"])
        for c in dec["counts"]:
            assert tp.count(c, "all-gather", "fsdp") == n_units, c
            assert "reduce-scatter" not in c, c


@pytest.mark.parametrize("world", LAYOUTS)
def test_fsdp_trainer_follows_one_device_run_of_the_seed(runs, world):
    for r in runs["ranks"][world]:
        for (la, ga), (lb, gb) in zip(r["trainer"],
                                      runs["one_device_trainer"]):
            assert abs(la - lb) <= 1e-5 and abs(ga - gb) <= 1e-5 * gb, (
                r["trainer"], runs["one_device_trainer"])


def test_fsdp_expert_parallel_moe_gathers_its_slices(runs):
    """The expert-parallel FFN over the TP ranks as the expert group, its
    router and experts sliced over the data group: the output of the
    whole leaves, and the slices' gradients those of the whole leaves
    summed over the data group; one all-gather and one reduce-scatter."""
    for r in runs["ranks"]["dp2xtp2"]:
        ep = r["ep"]
        assert ep["sliced"] == ["router", "wg", "wi", "wo"]
        assert ep["out_err"] <= 1e-6 and ep["grad_err"] <= 1e-5, ep
        c = ep["fsdp_counts"]
        assert tp.count(c, "all-gather", "fsdp") == 1
        assert tp.count(c, "reduce-scatter", "fsdp") == 1
        assert "fsdp" not in str(ep["whole_counts"])
