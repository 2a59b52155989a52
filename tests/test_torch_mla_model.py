"""The port's deepseek-v3 decoder (MLA attention, the MTP head, MoE layers
after ``first_dense_layers``) against the JAX package's, on the CPU in
fp32 at the reduced deepseek-v3-671b (d 128, 4 heads, kv_lora 32, 4
experts top 2 in 2 groups, a shared expert, ``mtp_depth`` 1), weights
carried across with ``interop.params_from_numpy``: the serving paths,
TP and checkpoints (the family gates, the parameter tree and training in
the six modes: ``test_torch_mla_train.py``).

* a packed tick, padded ticks (C = 1 and C = 6) and ``decode_step`` over
  ragged positions, outputs and the latent pools, against the reference's;
* the port's dual-branch ticks (packed, padded C == 1 and C == 5,
  contiguous) bit for bit its sequential ones (MLA blocks take the unfused
  route), and the reference's dual tick within 1e-4 (its own dual MLA test
  fails under jax 0.9, ROADMAP.md "Reference baseline");
* the paged engine's greedy streams, a repeated prompt served from the
  prefix cache (a hit and a COW copy) and the speculative engine's streams
  equal to the JAX engine's;
* explicit TP over two gloo ranks, fal and preln, with and without SP:
  logits, loss (ce, aux, mtp) and every gradient leaf against the
  reference's single device (its own TP MLA test fails under jax 0.9); the
  MTP head's gradients whole and equal on both ranks (not summed), MLA's
  replicated down-projections summed;
* a checkpoint with the ``mtp`` subtree written by the port restored by
  the reference and back.

Tolerances: logits and losses 1e-5, gradients 1e-6 plus 1e-4 of the leaf's
largest value (``test_torch_tp.py``'s), ticks 1e-4
(``test_torch_model.py``'s)."""
import concurrent.futures
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
from repro.serve import scheduler as RS  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.core.plan import ExecutionPlan as TPlan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402

import test_torch_decode as TDEC  # noqa: E402
import test_torch_dual_branch as TDB  # noqa: E402
import test_torch_model as TMOD  # noqa: E402
import test_torch_padded as TPAD  # noqa: E402
import test_torch_tp as TTP  # noqa: E402
import torch_tp_ranks as R  # noqa: E402
from test_torch_train import _close_tree  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = 1e-5
TICK_TOL = 1e-4


def _cfgs(**kw):
    return (ref_config(ARCH).reduced().replace(**kw),
            get_config(ARCH).reduced().replace(**kw))


@functools.lru_cache(maxsize=None)
def _models(connection="fal"):
    rcfg, tcfg = _cfgs(connection=connection)
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def _close(want, got, tol=TICK_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


# --------------------------------------------------------------------------- #
# the serving ticks
# --------------------------------------------------------------------------- #
def _filled(rcfg, tcfg, rng, P=24, page=4, slots=4):
    """The same random latent history in both packages' paged caches."""
    rc = RM.init_paged_cache(rcfg, P, page, slots, "float32")
    rc = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), rc)
    tc = TM.init_paged_cache(tcfg, P, page, slots, "float32", device="cpu")
    for part in ("block0", "blocks"):
        assert set(tc[part]) == {"c", "kr"}
        for name in tc[part]:
            tc[part][name].copy_(torch.from_numpy(np.array(rc[part][name])))
    tc["a1_sig"].copy_(torch.from_numpy(np.array(rc["a1_sig"])))
    return rc, tc


def _pools_close(rc, tc):
    for part in ("block0", "blocks"):
        for name in ("c", "kr"):                    # page 0 is scratch
            _close(np.asarray(rc[part][name])[..., 1:, :, :],
                   tc[part][name][..., 1:, :, :])


def _packed(plans=(None, None)):
    rcfg, rparams, tcfg, tparams = _models()
    rng = np.random.default_rng(0)
    rc, tc = _filled(rcfg, tcfg, rng, P=12)
    batch = TMOD._packed_batch(rcfg, rng)
    r_out, r_c = RM.paged_decode_step(
        rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()}, rc,
        plans[0], want="logits")
    t_out, t_c = TM.paged_decode_step(
        tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        tc, plans[1], want="logits")
    return batch, (np.asarray(r_out), r_c), (t_out, t_c)


def test_packed_tick_matches_reference():
    ops.reset_dispatch_paths()
    batch, (r_l, r_c), (t_l, t_c) = _packed()
    live = batch["tok_pos"] >= 0
    _close(r_l[0][live], t_l[0].numpy()[live])
    _close(r_c["a1_sig"], t_c["a1_sig"])
    _pools_close(r_c, t_c)
    # MLA's serving paths are PyTorch ops: no paged attention kernel
    assert "paged_packed_attention" not in ops.dispatch_paths()


def _padded(C, dual=False):
    rcfg, rparams, tcfg, tparams = _models()
    rng = np.random.default_rng(C)
    lanes = TPAD.LANES[C]
    B, Tb = len(lanes), 5
    rc, tc = _filled(rcfg, tcfg, rng, slots=B)
    batch = dict(
        tokens=rng.integers(0, rcfg.vocab, (B, C)).astype(np.int32),
        pos=np.array([p for p, _ in lanes], np.int32),
        n_valid=np.array([n for _, n in lanes], np.int32),
        block_tables=rng.permutation(np.arange(1, 24))[:B * Tb].reshape(
            B, Tb).astype(np.int32))
    r_out, r_c = RM.paged_decode_step(
        rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()}, rc,
        RPlan.single_device("paged"), want="logits")
    t_out, t_c = TM.paged_decode_step(
        tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        tc, TPlan.single_device("paged", dual_branch=dual), want="logits")
    live = np.arange(C)[None] < batch["n_valid"][:, None]
    return live, (np.asarray(r_out), r_c), (t_out, t_c)


@pytest.mark.parametrize("C", [1, 6])
def test_padded_tick_matches_reference(C):
    live, (r_l, r_c), (t_l, t_c) = _padded(C)
    _close(r_l[live], t_l.numpy()[live])
    _close(r_c["a1_sig"], t_c["a1_sig"])
    _pools_close(r_c, t_c)


def test_decode_step_matches_reference():
    """Ragged positions through 12 contiguous ticks: every tick's logits
    and the latent caches at the end."""
    rcfg, rparams, tcfg, tparams = _models()
    B, S = TDEC.B, TDEC.S
    toks = TDEC._tokens(rcfg.vocab)
    ticks = TDEC._ragged_ticks()
    rc = RM.init_cache(rcfg, B, S, "float32")
    r_out = []
    for pos in ticks:
        lg, rc = TDEC._ref_step(rparams, rcfg, {
            "tokens": jnp.asarray(toks[np.arange(B), list(pos)][:, None]),
            "pos": jnp.asarray(pos, jnp.int32)}, rc,
            RPlan.single_device("decode"))
        r_out.append(np.asarray(lg[:, 0]))
    t_out, tc = TDEC._decode(tcfg, tparams, toks, ticks)
    _close(np.stack(r_out), t_out)
    for part in ("block0", "blocks"):
        for name in ("c", "kr"):
            _close(rc[part][name], tc[part][name])


def test_dual_branch_ticks_bit_identical_to_sequential():
    """The port's dual packed tick, padded C == 1 / C == 5 ticks and
    contiguous decode equal its sequential ones bit for bit (no MLA block
    reaches the fused dual-branch dispatch), and its dual packed tick the
    reference's dual tick within 1e-4."""
    plans = (RPlan.single_device("paged", dual_branch=True),
             TPlan.single_device("paged", dual_branch=True))
    batch, (r_l, _), (t_dual, _) = _packed(plans)
    _, _, (t_seq, _) = _packed()
    assert torch.equal(t_dual, t_seq)
    live = batch["tok_pos"] >= 0
    _close(r_l[0][live], t_dual[0].numpy()[live])
    _, _, tcfg, tparams = _models()
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 12))
    for chunk in (1, 5):
        ops.reset_dispatch_paths()
        seq = TDB._port_logits(tcfg, tparams, toks, chunk, dual=False)
        dual = TDB._port_logits(tcfg, tparams, toks, chunk, dual=True)
        assert torch.equal(seq, dual), (seq - dual).abs().max().item()
        assert "dual_branch_decode" not in ops.dispatch_paths()
    toks = TDEC._tokens(tcfg.vocab)
    seq, _ = TDEC._decode(tcfg, tparams, toks, TDEC._ragged_ticks())
    dual, _ = TDEC._decode(tcfg, tparams, toks, TDEC._ragged_ticks(),
                           dual=True)
    assert np.array_equal(seq, dual)


# --------------------------------------------------------------------------- #
# the paged engine against the JAX engine
# --------------------------------------------------------------------------- #
def _serve(engine, mod, reqs):
    for rid, (prompt, n) in enumerate(reqs):
        engine.submit(mod.ServeRequest(rid=rid, prompt=prompt, max_new=n))
    done = engine.run()
    return {r.rid: (list(map(int, r.generated)), r.truncated) for r in done}


def _engines(**kw):
    rcfg, rparams, tcfg, tparams = _models()
    ecfg = dict(page_size=8, num_pages=48, slots=3, prefill_chunk=8,
                max_seq=96, cache_dtype="float32")
    ecfg.update(kw)
    return (RS.PagedEngine(rcfg, rparams, RS.EngineConfig(**ecfg)),
            TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**ecfg),
                           device="cpu"))


def _requests(n=6, seed=42):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, 4 + 3 * (i % 4)), 6 + 2 * (i % 3))
            for i in range(n)]


def test_engine_greedy_streams_match_reference():
    ref, port = _engines()
    assert _serve(port, TS, _requests()) == _serve(ref, RS, _requests())
    rs, ts = ref.stats(), port.stats()
    for key in ("ticks", "prefill_tokens", "decode_tokens"):
        assert ts[key] == rs[key], key
    # two latent pools of (page, rkv) and (page, dr) fp32 rows a layer
    cfg = port.cfg
    assert port.allocator.page_bytes == cfg.n_layers * 8 * 4 * (
        cfg.kv_lora_rank + cfg.qk_rope_head_dim)


def test_engine_prefix_hits_and_cow_match_reference():
    """A donor parks its page-aligned prefix; a verbatim repeat enters
    decode from the cache with one COW copy of its last shared page; the
    streams and the prefix statistics equal the JAX engine's."""
    sysp = np.random.default_rng(3).integers(1, 512, 16)
    reqs = [(sysp, 6), (np.concatenate([sysp, [7, 9]]), 5), (sysp, 6)]
    out = {}
    for name, mod, eng in zip(("ref", "port"), (RS, TS),
                              _engines(slots=1, prefix_cache=True)):
        out[name] = ([_serve(eng, mod, [r]) for r in reqs],
                     eng.stats()["prefix"])
    assert out["port"][0] == out["ref"][0]
    want, got = out["ref"][1], out["port"][1]
    for key in ("hits", "hit_tokens", "cow_copies"):
        assert got[key] == want[key], key
    assert got["hits"] >= 2 and got["cow_copies"] >= 1


def test_engine_speculative_streams_match_reference():
    ref, port = _engines(spec_tokens=3, draft_blocks=1)
    assert _serve(port, TS, _requests(5, seed=7)) == \
        _serve(ref, RS, _requests(5, seed=7))
    got, want = port.stats()["spec"], ref.stats()["spec"]
    for key in ("proposals_accepted", "proposals_rejected"):
        assert got[key] == want[key], key
    assert got["proposals_accepted"] + got["proposals_rejected"] > 0


# --------------------------------------------------------------------------- #
# explicit TP over two gloo ranks
# --------------------------------------------------------------------------- #
TP_CASES = {m: dict(connection=m) for m in ("fal", "preln")}


@pytest.fixture(scope="module")
def tp_case(tmp_path_factory):
    toks = np.random.default_rng(0).integers(0, 512, (2, 16)) \
        .astype(np.int32)
    weights = {m: TTP._weights(TTP._ref_cfg(m, arch=ARCH), 20 + i)
               for i, m in enumerate(TP_CASES)}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            tp.run_ranks, "torch_mla_ranks:tp_parity", 2, backend="gloo",
            threads=1, timeout=R.RANKS_TIMEOUT,
            workdir=str(tmp_path_factory.mktemp("mla_tp")),
            args=(ARCH, {m: (kw, weights[m]) for m, kw in TP_CASES.items()},
                  {"tokens": toks}))
        ref = {}
        for m in TP_CASES:
            cfg, batch = TTP._ref_cfg(m, arch=ARCH), {
                "tokens": jnp.asarray(toks)}

            def run(p, cfg=cfg, batch=batch):
                (value, metrics), grads = jax.value_and_grad(
                    lambda q: RM.loss_fn(q, cfg, batch), has_aux=True)(p)
                return RM.forward(p, cfg, batch)[0], value, metrics, grads
            lg, value, metrics, grads = jax.jit(run)(weights[m])
            ref[m] = (np.asarray(lg), float(value),
                      {k: float(v) for k, v in metrics.items()},
                      jax.tree.map(np.asarray, grads))
        return ref, ranks.result()


@pytest.mark.parametrize("mode", list(TP_CASES))
@pytest.mark.parametrize("sp", [False, True])
def test_tp_matches_reference_single_device(tp_case, mode, sp):
    ref, ranks = tp_case
    logits, loss, metrics, grads = ref[mode]
    got = [r[(mode, sp)] for r in ranks]
    tcfg = R.tp_config(mode, arch=ARCH)
    for r in got:
        _close(logits, r["logits"], TOL)
        assert abs(r["loss"] - loss) <= TOL
        for k in ("ce", "aux", "mtp"):
            assert abs(r["metrics"][k] - metrics[k]) <= TOL, k
    _close_tree(grads, MX.gather_params([r["grads"] for r in got], tcfg),
                tcfg, 1e-6, 1e-4)
    g0, g1 = (r["grads"] for r in got)
    # MLA: up-projections by heads, down-projections whole and summed
    assert g0["blocks"][0]["attn"]["w_uk"].shape[-1] * 2 == \
        tcfg.n_heads * tcfg.qk_nope_head_dim
    for k in TB.MLA_REPLICATED:
        a, b = g0["block0"]["attn"][k], g1["block0"]["attn"][k]
        a, b = (a["scale"], b["scale"]) if isinstance(a, dict) else (a, b)
        assert torch.equal(a, b), k
    # the MTP head is whole on every rank; its gradients are not summed
    for (path, a), (_, b) in zip(TO.named_leaves(g0["mtp"]),
                                 TO.named_leaves(g1["mtp"])):
        assert torch.equal(a, b), path


def test_tp_collective_counts(tp_case):
    """Forward all-reduces at L = 4: fal L + 1 = 5, preln 2 L = 8; the MTP
    head adds none (it runs outside the stack)."""
    for r in tp_case[1]:
        assert tp.count(r[("fal", False)]["forward"], "all-reduce") == 5
        assert tp.count(r[("preln", False)]["forward"], "all-reduce") == 8


# --------------------------------------------------------------------------- #
# checkpoints with the MTP head
# --------------------------------------------------------------------------- #
def test_checkpoint_with_mtp_crosses_both_ways(tmp_path):
    _, rparams, _, tparams = _models()
    TC.save(tmp_path / "port", {"params": tparams}, step=1)
    back = RC.restore(str(tmp_path / "port"),
                      {"params": jax.tree.map(jnp.zeros_like, rparams)})
    flat = {k: np.asarray(v) for k, v in RC._flatten(back).items()}
    assert any(k.startswith("params/mtp/block/attn/w_uq") for k in flat)
    for k, v in RC._flatten(jax.tree.map(np.asarray, rparams)).items():
        assert np.array_equal(flat[f"params/{k}"], v), k
    RC.save(str(tmp_path / "ref"), {"params": rparams}, step=2)
    like = {"params": TO.map_tree(torch.zeros_like, tparams)}
    got = TC.restore(tmp_path / "ref", like)["params"]
    want = dict(TO.named_leaves(tparams))
    for path, t in TO.named_leaves(got):
        assert torch.equal(t, want[path]), path
