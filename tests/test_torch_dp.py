"""Data parallelism of the port against the JAX package's single device, on
the CPU: gloo ranks (``core.tp.run_ranks`` with ``tp_size``, a ``file://``
rendezvous under ``tmp_path``, one intra-op thread a rank) train the
reduced llama3.2-3b at 4 layers (fal, fp32) on the reference's weights
drawn with numpy, at dp 2 x tp 1 and at dp 2 x tp 2, each with 1 and 2
microbatches, on one numpy global batch of 4 rows a step.

* 3 AdamW steps (clipped, decay on) follow the reference's one-device
  ``make_train_step``: loss at each step within 1e-5, ``grad_norm`` within
  1e-5 relative, the params after step 3 within 1e-6 plus 1e-4 of each
  leaf's largest value (the TP tests' gradient rule); every data replica
  holds the same params, bit for bit.
* Each step makes exactly ONE data-parallel all-reduce (direction
  ``data``), of 4 bytes times this rank's gradient elements, and one of
  the loss (direction ``metric``).
* The tp 2 x dp 2 world saves a checkpoint (``save_distributed``); the
  reference's ``checkpoint.restore`` reads it equal to the gathered state;
  ``restore_sharded`` gives back each rank's shards bit for bit, and a
  step after the restore equals a step without it.
* ``trainer.train`` over either world follows the one-device trainer of
  the same seed (the same global batches); the launcher trains under
  ``--tp explicit --dp 2`` with ``--ckpt``.

The two worlds are spawned once each, one after the other, while the
reference runs in the test process.
"""
import concurrent.futures
import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.optim import adamw as RO  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro.train import step as RT  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

import torch_dp_ranks as D  # noqa: E402
import torch_tp_ranks as R  # noqa: E402
from test_torch_tp import _ref_cfg, _weights  # noqa: E402
from test_torch_train import _close_tree  # noqa: E402

OCFG = dict(lr=3e-4, weight_decay=0.5, clip_norm=0.05)
STEPS, B, S = 3, 4, 16
#: (name, world size, tp size)
LAYOUTS = {"dp2": (2, 1), "dp2xtp2": (4, 2)}
TRAINER_KW = dict(steps=2, batch=B, seq_len=S, seed=0)


def _reference(weights, toks):
    cfg = _ref_cfg("fal")
    ocfg = RO.AdamWConfig(**OCFG)
    step = jax.jit(RT.make_train_step(cfg, ocfg))
    state = {"params": weights, "opt": RO.init_opt_state(weights, ocfg)}
    metrics = []
    for t in toks[:STEPS]:
        state, m = step(state, {"tokens": jnp.asarray(t)})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state["params"]), metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights = _weights(_ref_cfg("fal"), 0)
    toks = np.random.default_rng(1).integers(
        0, 512, (STEPS + 1, B, S)).astype(np.int32)
    ckpt = str(tmp_path_factory.mktemp("dp_ckpt"))

    def spawn_all():
        out = {}
        for name, (world, tp_size) in LAYOUTS.items():
            out[name] = tp.run_ranks(
                "torch_dp_ranks:dp_world", world, backend="gloo", threads=1,
                timeout=R.RANKS_TIMEOUT, tp_size=tp_size,
                workdir=str(tmp_path_factory.mktemp(f"dp_{name}")),
                args=(weights, toks, OCFG,
                      ckpt if name == "dp2xtp2" else None, TRAINER_KW))
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_all)
        ref = _reference(weights, toks)
        _, one = trainer.train(R.tp_config("fal"), device="cpu",
                               log_every=1, **TRAINER_KW)
        return {"ranks": ranks.result(), "ref": ref, "ckpt": ckpt,
                "weights": weights,
                "one_device_trainer": [(h["loss"], h["grad_norm"])
                                       for h in one]}


CASES = [(name, nm) for name in LAYOUTS for nm in (1, 2)]


def _gathered(ranks, key):
    """The full params of data rank 0 (its TP ranks' shards gathered)."""
    tcfg = R.tp_config("fal")
    shards = [r[key] for r in sorted(ranks, key=lambda r: r["tp_rank"])
              if r["dp_rank"] == 0]
    return MX.gather_params(shards, tcfg) if len(shards) > 1 else shards[0]


def test_layouts_rank_order(runs):
    """TP is the inner axis: rank = dp_rank * tp + tp_rank."""
    for name, (world, tp_size) in LAYOUTS.items():
        for r in runs["ranks"][name]:
            assert (r["tp_size"], r["dp_size"]) == (tp_size,
                                                    world // tp_size)
            assert r["rank"] == r["dp_rank"] * tp_size + r["tp_rank"]


@pytest.mark.parametrize("name,nm", CASES)
def test_dp_losses_and_norms_match_reference(runs, name, nm):
    _, ref_metrics = runs["ref"]
    assert ref_metrics[0]["grad_norm"] > OCFG["clip_norm"]
    for r in runs["ranks"][name]:
        for got, want in zip(r[nm]["metrics"], ref_metrics):
            assert abs(got["loss"] - want["loss"]) <= 1e-5, (got, want)
            assert abs(got["grad_norm"] - want["grad_norm"]) \
                <= 1e-5 * want["grad_norm"], (got, want)


@pytest.mark.parametrize("name,nm", CASES)
def test_dp_params_match_reference(runs, name, nm):
    ref_params, _ = runs["ref"]
    ranks = runs["ranks"][name]
    tcfg = R.tp_config("fal")
    _close_tree(ref_params, _gathered([dict(r, p=r[nm]["params"])
                                       for r in ranks], "p"),
                tcfg, 1e-6, 1e-4)
    by_tp = {}
    for r in ranks:              # the data replicas are bit-identical
        first = by_tp.setdefault(r["tp_rank"], r[nm]["params"])
        assert D._equal(first, r[nm]["params"]), r["rank"]


@pytest.mark.parametrize("name,nm", CASES)
def test_one_dp_allreduce_of_the_local_gradient_bytes(runs, name, nm):
    for r in runs["ranks"][name]:
        for c in r[nm]["counts"]:
            assert tp.count(c, "all-reduce", "data") == 1, c
            assert tp.count(c, "all-reduce", "data", "bytes") == \
                4 * r[nm]["n_local"], c
            assert tp.count(c, "all-reduce", "metric") == 1, c
            if r["tp_size"] == 1:
                assert set(c) == {"all-reduce"}, c
                assert set(c["all-reduce"]) == {"data", "metric"}, c


def test_checkpoint_reference_restores_gathered_state(runs):
    """The written file is the one-device format: the reference's
    ``restore`` (fp32 state) reads params, both moments and the count equal
    to the ranks' gathered state."""
    ranks = runs["ranks"]["dp2xtp2"]
    weights = runs["weights"]
    like = {"params": weights,
            "opt": RO.init_opt_state(weights, RO.AdamWConfig(**OCFG))}
    got = RC.restore(runs["ckpt"], like)
    tcfg = R.tp_config("fal")
    states = [dict(r, s=r["ckpt"]["state"]) for r in ranks]
    for key in ("params", "m", "v"):
        sub = [dict(r, t=r["s"]["params"] if key == "params"
                    else r["s"]["opt"][key]) for r in states]
        want = got["params"] if key == "params" else got["opt"][key]
        _close_tree(jax.tree.map(np.asarray, want), _gathered(sub, "t"),
                    tcfg, 0.0)
    assert int(got["opt"]["count"]) == STEPS == \
        ranks[0]["ckpt"]["state"]["opt"]["count"]


def test_checkpoint_restores_shards_bit_equal(runs):
    for r in runs["ranks"]["dp2xtp2"]:
        assert r["ckpt"]["restored_equal"], r["rank"]
        assert r["ckpt"]["requires_grad"], r["rank"]


def test_step_after_restore_equals_step_without(runs):
    for r in runs["ranks"]["dp2xtp2"]:
        assert r["ckpt"]["step_equal"], r["rank"]


@pytest.mark.parametrize("name", LAYOUTS)
def test_trainer_follows_one_device_run_of_the_seed(runs, name):
    """Every rank draws the global batch and trains on its rows: the
    losses and norms are the one-device trainer's."""
    for r in runs["ranks"][name]:
        for (la, ga), (lb, gb) in zip(r["trainer"],
                                      runs["one_device_trainer"]):
            assert abs(la - lb) <= 1e-5 and abs(ga - gb) <= 1e-5 * gb, (
                r["trainer"], runs["one_device_trainer"])


def test_trainer_refuses_a_batch_that_does_not_split():
    plan = ExecutionPlan(data_group=types.SimpleNamespace(
        size=lambda: 2, rank=lambda: 0))
    with pytest.raises(ValueError, match="does not split"):
        trainer.train(R.tp_config("fal"), steps=1, batch=6, seq_len=8,
                      num_microbatches=2, plan=plan, device="cpu")


def test_plan_data_axis():
    """dp_size / dp_rank come from the data group (1 and 0 without one);
    ``is_sharded`` stays about TP; the serving ticks refuse a data group
    (a data replica is a separate engine)."""
    fake = types.SimpleNamespace(size=lambda: 4, rank=lambda: 3)
    cfg = get_config("llama3.2-3b").reduced()
    plan = ExecutionPlan.from_group(None, tp="none", data_group=fake)
    assert plan.validate(cfg) is plan
    assert (plan.dp_size, plan.dp_rank, plan.tp_size) == (4, 3, 1)
    assert not plan.is_sharded and not plan.use_explicit_tp
    one = ExecutionPlan.single_device()
    assert (one.dp_size, one.dp_rank) == (1, 0)
    with pytest.raises(ValueError, match="separate engine"):
        M.decode_step(None, cfg, None, None, plan)


def test_launcher_trains_tp_dp_with_a_checkpoint(tmp_path):
    """Four ranks, --tp explicit --dp 2: every rank reports the same final
    loss (the global batch's), and the checkpoint the launcher wrote holds
    the whole model in the one-device format."""
    ckpt = tmp_path / "ckpt"
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "llama3.2-3b", "--reduced", "--steps", "2", "--batch", "4",
            "--seq", "16", "--device", "cpu", "--tp", "explicit", "--dp",
            "2", "--backend", "gloo", "--ckpt", str(ckpt),
            "--init-method", f"file://{tmp_path}/store"]
    logs = tp.spawn(argv, 4, workdir=str(tmp_path / "ranks"), threads=1,
                    timeout=R.RANKS_TIMEOUT)
    finals = {ln for log in logs for ln in log.splitlines()
              if ln.startswith("final loss")}
    assert len(finals) == 1, logs
    assert "tp=explicit x2 sp=False dp=2" in logs[0]
    cfg = get_config("llama3.2-3b").reduced()
    like = {"params": M.init_params(cfg, device="cpu", dtype="float32")}
    like["opt"] = TO.init_opt_state(like["params"], TO.AdamWConfig())
    from repro_torch.train import checkpoint as CK
    got = CK.restore(str(ckpt), like)
    assert got["opt"]["count"] == 2
    full = dict(TO.named_leaves(got["params"]))
    assert full[("block0", "attn", "wq")].shape == \
        like["params"]["block0"]["attn"]["wq"].shape
    assert all(torch.isfinite(t).all() for t in full.values())


def test_train_step_hands_its_gradients_to_on_grads():
    """``on_grads`` sees the step's final gradients (those ``make_grad_fn``
    leaves), once a step, before the update clips them in place."""
    from repro_torch.train import step as TT
    cfg = R.tp_config("fal")
    ocfg = TO.AdamWConfig(clip_norm=1e-3)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (2, 16)).astype(np.int32))}
    seen = []
    state = TT.init_state(0, cfg, ocfg, device="cpu")
    fresh = TO.map_tree(lambda t: t.detach().clone(), state["params"])
    step = TT.make_train_step(cfg, ocfg, on_grads=lambda p: seen.append(
        TO.map_tree(lambda t: t.grad.clone(), p)))
    step(state, batch)
    assert len(seen) == 1
    params = TT.init_state(0, cfg, ocfg, params=fresh)["params"]
    TT.make_grad_fn(cfg)(params, batch)
    assert D._equal(seen[0], TO.map_tree(lambda t: t.grad, params))
