"""The port's training slice against the JAX package on the CPU: the data
stream, the schedules, the full-sequence forward and loss, every gradient
leaf, one AdamW step (with the decay-mask trap), remat, microbatching, the
trainer's 30-step loss curve and its metrics, and the launcher.

Weights cross with ``interop.params_from_numpy(..., dtype="float32")`` (the
fp32 masters).  Tolerances, fp32 on both sides:

* logits, loss: 1e-5 (two layers of fp32 matmuls and a logsumexp summed in
  another order; logits of order 1);
* gradients: 1e-6 plus 1e-4 of the leaf's largest value (the same sums in
  another order; the tied embedding's two contributions are added in an
  order of autograd's choosing);
* the learning rate: relative 1e-6 (numpy's fp32 ``cos`` against XLA's);
* one AdamW step: the norm scales (where the decay-mask trap lives; a
  wrong mask moves them by lr * 0.5 = 1.5e-4) within 1e-6; the matmul
  weights within 2 lr, and at most 0.1% of all weights more than 1e-7
  apart.  A first step moves a weight by lr * g / (|g| + eps) plus the
  decay; where the clipped gradient g is near eps = 1e-8 that ratio turns on
  the gradient's last bits (in the first runs a few weights per leaf landed
  up to 1e-5 apart), and a gradient of either sign moves by up to 2 lr;
* the 30-step curve: losses within 1e-4 (rounding differences feed back
  through 30 updates).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.data import pipeline as RD  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.optim import schedules as RSch  # noqa: E402
from repro.train import step as RT  # noqa: E402
from repro.train import trainer as RTr  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.optim import schedules as TSch  # noqa: E402
from repro_torch.train import step as TT  # noqa: E402
from repro_torch.train import trainer as TTr  # noqa: E402

_init = jax.jit(RM.init_params, static_argnums=1)

#: (arch, connection): FAL, FAL+, the Pre-LN baseline, and GPT-2's
#: layernorm / gelu / learned positions
MODELS = [("llama3.2-3b", "fal"), ("llama3.2-3b", "falplus"),
          ("llama3.2-3b", "preln"), ("gpt2-117m", "preln")]


def _models(arch, connection, seed=1, **kw):
    rcfg = ref_config(arch).reduced().replace(connection=connection, **kw)
    tcfg = get_config(arch).reduced().replace(connection=connection, **kw)
    rparams = _init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, rparams, tcfg, _port_params(rparams, tcfg)


def _port_params(rparams, tcfg):
    return interop.params_from_numpy(jax.tree.map(np.asarray, rparams), tcfg,
                                     "cpu", dtype="float32")


def _tokens(cfg, B=2, S=24, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _close_tree(ref_tree, port_tree, cfg, atol, rel=0.0):
    """Compare a reference-layout tree with a port-layout tree leaf by
    leaf, through ``params_from_numpy``'s layout change.  Returns the
    fraction of elements more than 1e-7 apart."""
    want = _port_params(ref_tree, cfg)
    w_leaves = dict(TO.named_leaves(want))
    g_leaves = dict(TO.named_leaves(port_tree))
    assert w_leaves.keys() == g_leaves.keys()
    far = total = 0
    for path, w in w_leaves.items():
        diff = (g_leaves[path].detach() - w).abs()
        tol = atol + rel * w.abs().max().item()
        assert diff.max().item() <= tol, (path, diff.max().item(), tol)
        far += int((diff > 1e-7).sum())
        total += diff.numel()
    return far / total


@pytest.mark.parametrize("seed,step,host_id,num_hosts", [
    (0, 0, 0, 1), (3, 17, 0, 1), (5, 2, 1, 2)])
def test_synthetic_markov_bytes_equal(seed, step, host_id, num_hosts):
    kw = dict(vocab=512, seq_len=40, batch=4, seed=seed, host_id=host_id,
              num_hosts=num_hosts)
    r, t = RD.SyntheticMarkov(**kw), TD.SyntheticMarkov(**kw)
    a, b = r.batch_at(step)["tokens"], t.batch_at(step)["tokens"]
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert next(iter(r))["tokens"].tobytes() == \
        next(iter(t))["tokens"].tobytes()
    assert RD.unigram_entropy(r) == TD.unigram_entropy(t)


def test_memmap_tokens_bytes_equal(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    kw = dict(path=str(path), seq_len=32, batch=4, seed=2, host_id=1,
              num_hosts=2)
    for step in (0, 9):
        assert RD.MemmapTokens(**kw).batch_at(step)["tokens"].tobytes() == \
            TD.MemmapTokens(**kw).batch_at(step)["tokens"].tobytes()


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (3e-4, 50)), ("warmup_cosine", (1e-3, 7, 0.3, 0.0)),
    ("one_cycle", (3e-4, 50)), ("wsd", (3e-4, 50)), ("wsd", (2e-3, 9))])
def test_schedules_match_reference(name, args):
    ref, got = getattr(RSch, name)(*args), getattr(TSch, name)(*args)
    steps = np.arange(0, args[1] + 3)
    want = np.asarray(jax.jit(jax.vmap(ref))(jnp.asarray(steps)))
    got = np.array([got(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch,connection", MODELS)
def test_forward_and_loss_match_reference(arch, connection):
    rcfg, rparams, tcfg, tparams = _models(arch, connection)
    toks = _tokens(rcfg)
    r_logits, _, _ = RM.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)})
    ops.reset_dispatch_paths()
    with torch.no_grad():
        t_logits, aux, _ = TM.forward(tparams, tcfg,
                                      {"tokens": torch.from_numpy(toks)})
        t_loss, t_m = TM.loss_fn(tparams, tcfg,
                                 {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               atol=1e-5, rtol=0)
    r_loss, r_m = RM.loss_fn(rparams, rcfg, {"tokens": jnp.asarray(toks)})
    assert abs(float(t_loss) - float(r_loss)) <= 1e-5
    assert abs(float(t_m["ce"]) - float(r_m["ce"])) <= 1e-5
    assert float(aux) == 0.0
    paths = ops.dispatch_paths()
    assert paths["flash_attention"] == ops.PLAIN
    assert ("fused_ln_add" in paths) == (connection != "preln")


@pytest.mark.parametrize("arch,connection", [("llama3.2-3b", "fal"),
                                             ("gpt2-117m", "preln")])
def test_every_gradient_leaf_matches_jax_grad(arch, connection):
    rcfg, rparams, tcfg, tparams = _models(arch, connection, seed=2)
    toks = _tokens(rcfg, seed=4)
    grads = jax.jit(jax.grad(lambda p, b: RM.loss_fn(p, rcfg, b)[0]))(
        rparams, {"tokens": jnp.asarray(toks)})
    leaves = [t for _, t in TO.named_leaves(tparams)]
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TM.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    loss.backward()
    _close_tree(jax.tree.map(np.asarray, grads),
                TO.map_tree(lambda p: p.grad, tparams), tcfg, 1e-6, 1e-4)


def test_remat_gives_equal_gradients():
    """Under ``cfg.remat`` the blocks and the CE tail are recomputed in the
    backward (the Functions give the same bits again): the gradients equal
    the gradients without remat."""
    grads = []
    for remat in (False, True):
        _, _, tcfg, tparams = _models("llama3.2-3b", "fal", seed=3,
                                      remat=remat)
        for _, p in TO.named_leaves(tparams):
            p.requires_grad_(True)
        loss, _ = TM.loss_fn(tparams, tcfg,
                             {"tokens": torch.from_numpy(_tokens(tcfg))})
        loss.backward()
        grads.append({k: p.grad for k, p in TO.named_leaves(tparams)})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, atol=1e-7, rtol=1e-6)


def _one_step(arch, connection, ocfg_kw, num_microbatches=1, B=4):
    rcfg, rparams, tcfg, tparams = _models(arch, connection, seed=5)
    toks = _tokens(rcfg, B=B, seed=6)
    r_ocfg, t_ocfg = RO.AdamWConfig(**ocfg_kw), TO.AdamWConfig(**ocfg_kw)
    r_step = jax.jit(RT.make_train_step(rcfg, r_ocfg, None,
                                        num_microbatches))
    r_state, r_m = r_step({"params": rparams,
                           "opt": RO.init_opt_state(rparams, r_ocfg)},
                          {"tokens": jnp.asarray(toks)})
    t_state = TT.init_state(0, tcfg, t_ocfg, params=tparams)
    t_step = TT.make_train_step(tcfg, t_ocfg, None, num_microbatches)
    t_state, t_m = t_step(t_state, {"tokens": torch.from_numpy(toks)})
    return tcfg, (r_state, r_m), (t_state, t_m)


def _close_step(r_state, t_state, tcfg, lr):
    """Post-step params against the reference's (see the module
    docstring): norm scales within 1e-6, everything within 2 lr, at most
    0.1% of the weights more than 1e-7 apart."""
    ref = jax.tree.map(np.asarray, r_state["params"])
    assert _close_tree(ref, t_state["params"], tcfg, 2 * lr) <= 1e-3
    want = dict(TO.named_leaves(_port_params(ref, tcfg)))
    for path, t in TO.named_leaves(t_state["params"]):
        if t.dim() == 1:
            assert (t.detach() - want[path]).abs().max().item() <= 1e-6, path


def test_one_step_matches_reference_with_the_decay_mask():
    """One AdamW step with weight_decay = 0.5 (so the decay of the norm
    scales of the blocks after block 0, which the reference decays because
    they are stacked there, moves them by lr * 0.5) and a clip norm the
    gradient exceeds: post-step params, both moments and the count equal
    the reference's."""
    kw = dict(lr=3e-4, weight_decay=0.5, clip_norm=0.05)
    tcfg, (r_state, r_m), (t_state, t_m) = _one_step("llama3.2-3b", "fal",
                                                     kw)
    assert float(r_m["grad_norm"]) > 0.05          # clipping triggered
    assert abs(float(t_m["grad_norm"]) - float(r_m["grad_norm"])) \
        <= 1e-5 * float(r_m["grad_norm"])
    assert abs(float(t_m["loss"]) - float(r_m["loss"])) <= 1e-5
    _close_step(r_state, t_state, tcfg, kw["lr"])
    for k in ("m", "v"):
        _close_tree(jax.tree.map(np.asarray, r_state["opt"][k]),
                    t_state["opt"][k], tcfg, 1e-8, 1e-4)
    assert t_state["opt"]["count"] == int(r_state["opt"]["count"]) == 1
    # the trap itself: a later block's norm scale was decayed, block 0's
    # and the final norm's were not (their step is the Adam step alone)
    blk = t_state["params"]["blocks"][0]["ln1"]["scale"].detach()
    b0 = t_state["params"]["block0"]["ln1"]["scale"].detach()
    assert TO.decay_mask(("blocks", 0, "ln1", "scale"), blk)
    assert not TO.decay_mask(("block0", "ln1", "scale"), b0)
    assert not TO.decay_mask(("final_norm", "scale"),
                             t_state["params"]["final_norm"]["scale"])


def test_microbatches_match_reference():
    tcfg, (r_state, r_m), (t_state, t_m) = _one_step(
        "llama3.2-3b", "fal", dict(lr=3e-4), num_microbatches=2)
    assert set(t_m) == {"loss", "grad_norm"}
    assert abs(float(t_m["loss"]) - float(r_m["loss"])) <= 1e-5
    assert abs(float(t_m["grad_norm"]) - float(r_m["grad_norm"])) \
        <= 1e-5 * float(r_m["grad_norm"])
    _close_step(r_state, t_state, tcfg, 3e-4)


def test_trainer_30_step_curve_matches_reference(capsys):
    """``trainer.train`` for 30 steps on the synthetic Markov stream from
    the reference's initial weights: the logged losses and grad norms
    follow the reference's, and the metrics registry carries the
    reference's names."""
    cfg_kw = dict(steps=30, batch=4, seq_len=32, log_every=1, seed=0)
    rcfg = ref_config("llama3.2-3b").reduced()
    tcfg = get_config("llama3.2-3b").reduced()
    _, r_hist = RTr.train(rcfg, **cfg_kw)
    p0 = RM.init_params(jax.random.PRNGKey(0), rcfg)
    _, t_hist = TTr.train(tcfg, device="cpu", eval_every=10,
                          params=_port_params(p0, tcfg), **cfg_kw)
    capsys.readouterr()
    assert len(t_hist) == len(r_hist) == 30
    for r, t in zip(r_hist, t_hist):
        assert t["step"] == r["step"]
        assert abs(t["loss"] - r["loss"]) <= 1e-4, (r["step"], t, r)
        assert abs(t["grad_norm"] - r["grad_norm"]) \
            <= 1e-3 * r["grad_norm"]
    assert t_hist[-1]["loss"] < t_hist[0]["loss"]


def test_trainer_metrics_and_eval():
    from repro_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    cfg = get_config("llama3.2-3b").reduced()
    TTr.train(cfg, steps=3, batch=2, seq_len=16, log_every=0, eval_every=2,
              device="cpu", metrics=reg)
    d = reg.to_dict()
    assert reg.get("train_steps_total").value == 3
    assert reg.get("train_tokens_total").value == 3 * 2 * 16
    assert reg.get("train_step_ms").count == 3
    assert {"train_loss", "train_grad_norm", "train_eval_ppl"} <= set(d)


def test_eval_step_matches_reference():
    rcfg, rparams, tcfg, tparams = _models("llama3.2-3b", "fal", seed=8)
    toks = _tokens(rcfg, seed=9)
    r = RT.make_eval_step(rcfg)(rparams, {"tokens": jnp.asarray(toks)})
    t = TT.make_eval_step(tcfg)(tparams, {"tokens": torch.from_numpy(toks)})
    for k in ("loss", "ce", "ppl"):
        assert abs(float(t[k]) - float(r[k])) <= 1e-5 * max(1.0,
                                                            float(r[k]))


def test_launcher_trains_on_cpu_and_refuses_later_slices(capsys, tmp_path):
    args = ["--arch", "llama3.2-3b", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "16", "--device", "cpu"]
    _, hist = TL.main(args)
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss"])
    assert "final loss" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="distributed slice"):
        TL.main(args + ["--mesh", "single"])
    # explicit TP runs one process per rank (tests/test_torch_tp_structure.py
    # trains under two); without a process group it refuses, and gspmd has
    # no PyTorch counterpart
    with pytest.raises(RuntimeError, match="needs a process group"):
        TL.main(args + ["--tp", "explicit"])
    with pytest.raises(NotImplementedError, match="gspmd"):
        TL.main(args + ["--tp", "gspmd"])
    # --ckpt writes the reference's checkpoint format after the last step
    # (tests/test_torch_checkpoint.py restores it in both packages)
    from repro.train import checkpoint as RC
    TL.main(args + ["--ckpt", str(tmp_path / "ckpts")])
    assert RC.latest_step(str(tmp_path / "ckpts")) == 2
    assert (tmp_path / "ckpts" / "ckpt_2.npz").is_file()
