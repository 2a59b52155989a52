"""Explicit tensor parallelism of the port against the JAX package's single
device, on the CPU: two ranks over gloo (``core.tp.run_ranks``, a
``file://`` rendezvous under ``tmp_path``, one intra-op thread a rank)
run the reduced llama3.2-3b at 4 layers in fp32 on the reference's
weights drawn with numpy.  For each of the six connection modes,
replicated TP and sequence-parallel TP give the reference's ``forward``
logits and ``jax.grad`` of its loss on every leaf (the ranks' shards
gathered with ``launch.mesh.gather_params``); so do TP with the KV heads
replicated (``n_kv_heads = 1`` at tp = 2), the reduced qwen3-4b (qk-norms)
and the reduced gemma2-27b (post-norms, windows, softcaps); and two TP
train steps (AdamW, clipped, decay on) follow the reference trainer, with
every replicated leaf equal on both ranks.

The reference's own TP paths are not used: they fail under jax 0.9
(ROADMAP.md Queue 3).  One spawn of two ranks serves every case here.

Tolerances (fp32 on both sides), those of ``test_torch_train.py``:
logits and loss 1e-5, gradients 1e-6 plus 1e-4 of the leaf's largest value,
post-step weights as its ``_close_step``.  The partial sums add each
rank's heads and FFN columns in another order than one device does; that
reassociation is of the size those tolerances already allow for (the
largest gradient difference seen was 4e-6 of a leaf's largest value), so
none is loosened.
"""
import concurrent.futures

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.train import step as RT  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
from test_torch_train import _close_step, _close_tree  # noqa: E402

TRAIN_OCFG = dict(lr=3e-4, weight_decay=0.5, clip_norm=0.05)
TRAIN_STEPS = 2


#: {case: config kwargs}: the six modes, the KV heads replicated
#: (n_kv_heads = 1 < tp = 2), qk-norms (qwen3) and post-norms with local /
#: global windows and softcaps (gemma2, whose FAL blocks all assemble)
CASES = {**{m: dict(connection=m) for m in R.MODES},
         "kv1": dict(connection="fal", n_kv_heads=1),
         "qwen3": dict(connection="fal", arch="qwen3-4b"),
         "gemma2": dict(connection="fal", arch="gemma2-27b")}


def _ref_cfg(connection, arch="llama3.2-3b", **kw):
    return ref_config(arch).reduced().replace(
        connection=connection, n_layers=4, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(cfg, seed):
    """Reference-layout weights drawn with numpy: matrices normal over
    sqrt(fan-in), embeddings 0.02 normal, norm scales 1 + 0.1 normal and
    biases 0.1 normal (so that the norms' gradients are not all alike)."""
    shapes = jax.eval_shape(lambda k: RM.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * z
        if name == "bias":
            return 0.1 * z
        if name == "emb":
            return 0.02 * z
        return z / np.sqrt(leaf.shape[-2])
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _reference(cfg, params, toks):
    """The reference's single-device logits, loss and ``jax.grad``."""
    batch = {"tokens": jnp.asarray(toks)}

    def run(p):
        value, grads = jax.value_and_grad(
            lambda q: RM.loss_fn(q, cfg, batch)[0])(p)
        return RM.forward(p, cfg, batch)[0], value, grads
    logits, value, grads = jax.jit(run)(params)
    return np.asarray(logits), float(value), _np(grads)


def _reference_steps(params, toks):
    ocfg = RO.AdamWConfig(**TRAIN_OCFG)
    step = jax.jit(RT.make_train_step(_ref_cfg("fal"), ocfg))
    state = {"params": params, "opt": RO.init_opt_state(params, ocfg)}
    metrics = []
    for t in toks:
        state, m = step(state, {"tokens": jnp.asarray(t)})
        metrics.append({k: float(v) for k, v in m.items()})
    return _np(state["params"]), metrics


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The two-rank run on numpy weights per mode, and the reference's
    results on the same weights, computed while the ranks run."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
    cfgs = {name: _ref_cfg(**kw) for name, kw in CASES.items()}
    weights = {m: _weights(c, i) for i, (m, c) in enumerate(cfgs.items())}
    train_toks = rng.integers(0, 512, (TRAIN_STEPS, 4, 16)).astype(np.int32)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            tp.run_ranks, "torch_tp_ranks:parity", 2, backend="gloo",
            threads=1, workdir=str(tmp_path_factory.mktemp("tp_parity")),
            args=({m: (CASES[m], weights[m]) for m in CASES}, toks,
                  (weights["fal"], train_toks, TRAIN_OCFG, TRAIN_STEPS)))
        ref = {m: _reference(c, weights[m], toks) for m, c in cfgs.items()}
        ref["train"] = _reference_steps(weights["fal"], train_toks)
        return {"ref": ref, "ranks": ranks.result()}


def _check(case, key, ref):
    ranks = [r[key] for r in case["ranks"]]
    logits, loss, grads = ref
    tcfg = R.tp_config(**CASES[key[0]])
    for r in ranks:               # the logits are replicated on every rank
        np.testing.assert_allclose(r["logits"].numpy(), logits, atol=1e-5,
                                   rtol=0)
        assert abs(r["loss"] - loss) <= 1e-5
    _close_tree(grads, MX.gather_params([r["grads"] for r in ranks], tcfg),
                tcfg, 1e-6, 1e-4)


@pytest.mark.parametrize("mode", R.MODES)
def test_tp_matches_reference_single_device(case, mode):
    _check(case, (mode, False), case["ref"][mode])


@pytest.mark.parametrize("mode", R.MODES)
def test_sp_matches_reference_single_device(case, mode):
    _check(case, (mode, True), case["ref"][mode])


@pytest.mark.parametrize("sp", [False, True])
def test_kv_replicated_matches_reference(case, sp):
    """n_kv_heads = 1 < tp = 2: wk / wv whole on both ranks, each slicing
    its KV group; their gradients are partial sums the step adds."""
    _check(case, ("kv1", sp), case["ref"]["kv1"])
    shard = case["ranks"][0][("kv1", sp)]["grads"]
    assert shard["block0"]["attn"]["wk"].shape[-1] == 32       # whole


@pytest.mark.parametrize("name", ["qwen3", "gemma2"])
@pytest.mark.parametrize("sp", [False, True])
def test_norm_variants_match_reference(case, name, sp):
    """qk-norms (partial gradients over each rank's heads) and post-norms
    (every block assembles; FAL's signal enters each MLP input whole)."""
    _check(case, (name, sp), case["ref"][name])


def test_tp_train_steps_match_reference(case):
    ref_params, ref_metrics = case["ref"]["train"]
    assert ref_metrics[0]["grad_norm"] > TRAIN_OCFG["clip_norm"]
    ranks = [r["train"] for r in case["ranks"]]
    for r in ranks:
        for got, want in zip(r["metrics"], ref_metrics):
            assert abs(got["loss"] - want["loss"]) <= 1e-5
            assert abs(got["grad_norm"] - want["grad_norm"]) \
                <= 1e-5 * want["grad_norm"]
    tcfg = R.tp_config("fal")
    full = {"params": MX.gather_params([r["params"] for r in ranks], tcfg)}
    # _close_step's bound of 2 lr is for one step: 2 lr a step here
    _close_step({"params": ref_params}, full, tcfg,
                TRAIN_OCFG["lr"] * TRAIN_STEPS)


def test_replicated_leaves_equal_across_ranks(case):
    """After the train steps every replicated leaf (norms, embedding) is
    bit-equal on both ranks, and the shards differ."""
    p0, p1 = (r["train"]["params"] for r in case["ranks"])
    tcfg = R.tp_config("fal")
    sharded = MX.sharded_paths(p0, tcfg, 2)
    leaves1 = dict(TO.named_leaves(p1))
    n_rep = 0
    for path, t in TO.named_leaves(p0):
        if path in sharded:
            assert not torch.equal(t, leaves1[path]), path
        else:
            assert torch.equal(t, leaves1[path]), path
            n_rep += 1
    assert n_rep > 10
