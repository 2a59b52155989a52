"""The port's MoE decoder against the JAX package's, on the CPU in fp32, at
the reduced qwen3-moe-30b-a3b (d 128, 4 experts of 64, top 2, capacity
factor 4: dropless), weights carried across with
``interop.params_from_numpy``.

* the family gates: ``check_supported``, ``params_from_numpy`` and
  ``ExecutionPlan.validate`` (explicit TP) take the MoE family; SSM,
  hybrid and audio still raise (MLA and the VLM: ``test_torch_mla_model.py``,
  ``test_torch_vlm.py``);
* in all six connection modes: forward logits, ``loss_fn`` (ce and aux)
  and ``jax.grad`` of the loss on every leaf; also with
  ``first_dense_layers = 2`` (``blocks_dense`` and ``blocks_moe`` both
  present) and with group-limited routing and a shared expert;
* one packed and one padded tick (C = 1 and C = 6), and ``decode_step``
  over ragged positions, against the reference's;
* a dual-branch packed tick and a dual-branch C == 1 padded tick bit for
  bit the port's sequential ones (MoE blocks take the unfused route: no
  fused dual-branch dispatch);
* a checkpoint written by the port restored by the reference, and one
  written by the reference restored by the port, leaf for leaf;
* explicit TP over two gloo ranks, fal and preln, with and without SP:
  logits, loss and gradients (router included) against the reference's
  single device, the dense stack's collective counts, and one train step;
* ``launch.train --arch qwen3-moe-30b-a3b --reduced``.

Tolerances: logits and loss 1e-5 (TP: the reference's 5e-4 bound is not
needed, 1e-5 holds), gradients 1e-6 plus 1e-4 of the leaf's largest value
(``test_torch_tp.py``'s), ticks 1e-4 (``test_torch_model.py``'s).
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
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro.train import step as RT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.core.plan import ExecutionPlan as TPlan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402

import test_torch_decode as TDEC  # noqa: E402
import test_torch_dual_branch as TDB  # noqa: E402
import test_torch_model as TMOD  # noqa: E402
import test_torch_padded as TPAD  # noqa: E402
import test_torch_tp as TTP  # noqa: E402
import torch_tp_ranks as R  # noqa: E402
from test_torch_train import _close_tree  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
MODES = R.MODES
TOL = 1e-5


def _cfgs(**kw):
    return (ref_config(ARCH).reduced().replace(**kw),
            get_config(ARCH).reduced().replace(**kw))


# --------------------------------------------------------------------------- #
# the family gates
# --------------------------------------------------------------------------- #
def test_moe_family_is_accepted_and_the_rest_still_raise():
    rcfg, tcfg = _cfgs()
    TM.check_supported(get_config(ARCH))
    group = types.SimpleNamespace(size=lambda: 2, rank=lambda: 0)
    TPlan.from_group(group, tp="explicit").validate(get_config(ARCH))
    with pytest.raises(ValueError, match="n_experts"):
        TPlan.from_group(types.SimpleNamespace(size=lambda: 3,
                                               rank=lambda: 0),
                         tp="explicit").validate(
            get_config(ARCH).replace(n_heads=33, n_kv_heads=3))
    rparams = RM.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    assert [TB.is_moe(b) for b in [tparams["block0"]] + tparams["blocks"]] \
        == [True, True]
    assert tparams["blocks"][0]["ffn"]["wi"].shape == (4, 128, 64)
    # the SSM, hybrid and audio families are accepted too: their
    # reference trees cross through params_from_numpy
    import test_torch_ssm as TSSM
    for arch in ("mamba2-370m", "zamba2-1.2b", "whisper-small"):
        TM.check_supported(get_config(arch))
        TSSM.init_tree_matches(arch)


def test_init_params_matches_the_reference_tree():
    """Depth order: block 0 and the first_dense_layers - 1 dense blocks of
    width dense_d_ff, then the MoE blocks, leaf shapes as the reference's
    stacks unstacked."""
    kw = dict(first_dense_layers=2, dense_d_ff=128, n_layers=4,
              n_shared_experts=1)
    rcfg, tcfg = _cfgs(**kw)
    shapes = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                            jax.random.PRNGKey(0))
    tparams = TM.init_params(tcfg, device="cpu")
    assert TM.layer_kinds(tcfg) == ["dense", "dense", "moe", "moe"]
    assert [TB.is_moe(b) for b in tparams["blocks"]] == [False, True, True]
    ref = interop.params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), tcfg,
        "cpu")
    got, want = dict(TO.named_leaves(tparams)), dict(TO.named_leaves(ref))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k


# --------------------------------------------------------------------------- #
# forward, loss and gradients
# --------------------------------------------------------------------------- #
#: {case: config kwargs}: the six modes; dense blocks before the MoE ones;
#: group-limited routing with a shared expert
FWD_CASES = {**{m: dict(connection=m) for m in MODES},
             "dense_first": dict(first_dense_layers=2, dense_d_ff=128,
                                 n_layers=3),
             "groups_shared": dict(route_groups=2, route_group_limit=1,
                                   n_shared_experts=1)}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_forward_loss_and_gradients_match_reference(case):
    rcfg, tcfg = _cfgs(**FWD_CASES[case])
    params = TTP._weights(rcfg, 11)
    toks = np.random.default_rng(2).integers(0, rcfg.vocab, (2, 20)) \
        .astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}

    def run(p):
        (value, metrics), grads = jax.value_and_grad(
            lambda q: RM.loss_fn(q, rcfg, batch), has_aux=True)(p)
        return RM.forward(p, rcfg, batch)[0], value, metrics, grads
    r_logits, r_loss, r_m, r_grads = jax.jit(run)(params)
    assert float(r_m["aux"]) > 0
    tparams = interop.params_from_numpy(params, tcfg, "cpu",
                                        dtype="float32")
    for _, t in TO.named_leaves(tparams):
        t.requires_grad_(True)
    tb = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        logits = TM.forward(tparams, tcfg, tb)[0]
    loss, m = TM.loss_fn(tparams, tcfg, tb)
    loss.backward()
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               atol=TOL, rtol=0)
    assert abs(float(loss.detach()) - float(r_loss)) <= TOL
    assert abs(float(m["aux"].detach()) - float(r_m["aux"])) <= TOL
    assert abs(float(m["ce"].detach()) - float(r_m["ce"])) <= TOL
    _close_tree(jax.tree.map(np.asarray, r_grads),
                TO.map_tree(lambda t: t.grad, tparams), tcfg, 1e-6, 1e-4)


# --------------------------------------------------------------------------- #
# the serving ticks
# --------------------------------------------------------------------------- #
def _close(want, got):
    np.testing.assert_allclose(got, np.asarray(want), atol=TMOD.TOL, rtol=0)


def test_packed_tick_matches_reference():
    """Padding rows included: the reference routes them too, and they take
    capacity."""
    batch, (r_l, r_c), (t_l, t_c) = TMOD._tick(ARCH, "fal", want="logits")
    live = batch["tok_pos"] >= 0
    _close(r_l[0][live], t_l[0].numpy()[live])
    _close(r_c["a1_sig"], t_c["a1_sig"].numpy())
    for part in ("block0", "blocks"):
        for name in ("k", "v"):
            _close(np.asarray(r_c[part][name])[..., 1:, :, :, :],
                   t_c[part][name].numpy()[..., 1:, :, :, :])


@pytest.mark.parametrize("C", [1, 6])
def test_padded_tick_matches_reference(C):
    live, (r_l, r_c), (t_l, t_c) = TPAD._tick(ARCH, "fal", C, False,
                                              want="logits")
    TPAD._close(r_l[live], t_l[live])
    TPAD._close(r_c["a1_sig"], t_c["a1_sig"].numpy())
    assert "dual_branch_decode" not in ops.dispatch_paths()


def test_decode_step_matches_reference():
    TDEC.test_decode_step_matches_reference(ARCH, "fal", {})


def test_dual_branch_ticks_bit_identical_to_sequential():
    """Packed: the port's dual tick equals its sequential tick bit for bit
    and the reference's dual tick within 1e-4.  Padded C == 1 and C == 5:
    dual equals sequential bit for bit, and no MoE block reaches the fused
    dual-branch dispatch (it would take expert weights for a swiglu)."""
    plans = (RPlan.single_device("paged", dual_branch=True),
             TPlan.single_device("paged", dual_branch=True))
    batch, (r_h, _), (t_dual, _) = TMOD._tick(ARCH, "fal", plans=plans)
    _, _, (t_seq, _) = TMOD._tick(ARCH, "fal")
    assert torch.equal(t_dual, t_seq)
    live = batch["tok_pos"] >= 0
    _close(r_h[0][live], t_dual[0].numpy()[live])
    tcfg = get_config(ARCH).reduced()
    params = TM.init_params(tcfg, seed=0, device="cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 12))
    for chunk in (1, 5):
        ops.reset_dispatch_paths()
        seq = TDB._port_logits(tcfg, params, toks, chunk, dual=False)
        dual = TDB._port_logits(tcfg, params, toks, chunk, dual=True)
        assert torch.equal(seq, dual), (seq - dual).abs().max().item()
        assert "dual_branch_decode" not in ops.dispatch_paths()


# --------------------------------------------------------------------------- #
# checkpoints both ways
# --------------------------------------------------------------------------- #
def test_checkpoints_cross_both_ways(tmp_path):
    """blocks_dense and blocks_moe: the port's save read by the reference's
    restore, the reference's save read by the port's, every leaf equal."""
    rcfg, tcfg = _cfgs(first_dense_layers=2, dense_d_ff=128, n_layers=4)
    rparams = RM.init_params(jax.random.PRNGKey(3), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu", dtype="float32")
    TC.save(tmp_path / "port", {"params": tparams}, step=1)
    back = RC.restore(str(tmp_path / "port"),
                      {"params": jax.tree.map(jnp.zeros_like, rparams)})
    flat = {k: np.asarray(v) for k, v in RC._flatten(back).items()}
    assert {k.split("/")[1] for k in flat} >= {"blocks_dense", "blocks_moe"}
    for k, v in RC._flatten(jax.tree.map(np.asarray, rparams)).items():
        assert np.array_equal(flat[f"params/{k}"], v), k
    RC.save(str(tmp_path / "ref"), {"params": rparams}, step=2)
    like = {"params": TO.map_tree(torch.zeros_like, tparams)}
    got = TC.restore(tmp_path / "ref", like)["params"]
    want = dict(TO.named_leaves(tparams))
    for path, t in TO.named_leaves(got):
        assert torch.equal(t, want[path]), path


# --------------------------------------------------------------------------- #
# explicit TP over two gloo ranks
# --------------------------------------------------------------------------- #
TP_CASES = {m: dict(connection=m) for m in ("fal", "preln")}
TRAIN_OCFG = dict(lr=3e-4, weight_decay=0.5, clip_norm=0.05)


def _ref_cfg(connection):
    return TTP._ref_cfg(connection, arch=ARCH)


@pytest.fixture(scope="module")
def tp_case(tmp_path_factory):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
    weights = {m: TTP._weights(_ref_cfg(m), 20 + i)
               for i, m in enumerate(TP_CASES)}
    step_toks = rng.integers(0, 512, (4, 16)).astype(np.int32)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            tp.run_ranks, "torch_moe_ranks:tp_parity", 2, backend="gloo",
            threads=1, timeout=R.RANKS_TIMEOUT,
            workdir=str(tmp_path_factory.mktemp("moe_tp")),
            args=({m: (kw, weights[m]) for m, kw in TP_CASES.items()}, toks,
                  (weights["fal"], step_toks, TRAIN_OCFG)))
        ref = {m: TTP._reference(_ref_cfg(m), weights[m], toks)
               for m in TP_CASES}
        ocfg = RO.AdamWConfig(**TRAIN_OCFG)
        state = {"params": weights["fal"],
                 "opt": RO.init_opt_state(weights["fal"], ocfg)}
        _, m = jax.jit(RT.make_train_step(_ref_cfg("fal"), ocfg))(
            state, {"tokens": jnp.asarray(step_toks)})
        ref["train"] = {k: float(v) for k, v in m.items()}
        return ref, ranks.result()


@pytest.mark.parametrize("mode", list(TP_CASES))
@pytest.mark.parametrize("sp", [False, True])
def test_tp_matches_reference_single_device(tp_case, mode, sp):
    ref, ranks = tp_case
    logits, loss, grads = ref[mode]
    got = [r[(mode, sp)] for r in ranks]
    tcfg = R.tp_config(mode, arch=ARCH)
    for r in got:
        np.testing.assert_allclose(r["logits"].numpy(), logits, atol=TOL,
                                   rtol=0)
        assert abs(r["loss"] - loss) <= TOL
    _close_tree(grads, MX.gather_params([r["grads"] for r in got], tcfg),
                tcfg, 1e-6, 1e-4)
    # each rank holds half the experts; the router whole, its gradient
    # summed by the step's sync
    assert got[0]["grads"]["blocks"][0]["ffn"]["wi"].shape[0] == 2
    assert torch.equal(got[0]["grads"]["blocks"][0]["ffn"]["router"],
                       got[1]["grads"]["blocks"][0]["ffn"]["router"])


@pytest.mark.parametrize("mode,sp,ar,rs", [
    ("fal", False, 5, 0), ("preln", False, 8, 0),
    ("fal", True, 1, 4), ("preln", True, 0, 8)])
def test_tp_collective_counts_are_the_dense_stacks(tp_case, mode, sp, ar,
                                                   rs):
    """Forward collectives at L = 4: fal L + 1 all-reduces, preln 2 L;
    under SP block 0's export stays an all-reduce and the rest become
    reduce-scatters.  The MoE layers add none (routing is replicated; the
    experts' partial sums join the block's reduction), and no all-to-all."""
    for r in tp_case[1]:
        c = r[(mode, sp)]["forward"]
        assert tp.count(c, "all-reduce") == ar
        assert tp.count(c, "reduce-scatter") == rs
        assert tp.count(c, "all-to-all") == 0


def test_tp_train_step_matches_reference(tp_case):
    ref, ranks = tp_case
    want = ref["train"]
    assert want["grad_norm"] > TRAIN_OCFG["clip_norm"]
    for r in ranks:
        got = r["train"]
        assert abs(got["loss"] - want["loss"]) <= TOL
        assert abs(got["aux"] - want["aux"]) <= TOL
        assert abs(got["grad_norm"] - want["grad_norm"]) \
            <= 1e-5 * want["grad_norm"]


def test_launcher_trains_the_moe_arch():
    _, hist = TL.main(["--arch", ARCH, "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--lr", "1e-3"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
