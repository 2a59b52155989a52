"""Explicit tensor parallelism of the ssm, hybrid and audio families against
the JAX package's single device, on the CPU: gloo ranks
(``core.tp.run_ranks``, one intra-op thread a rank) run the reduced configs
in fp32 on the reference's weights (its ``init_params``, the norms' scales
and biases redrawn so that their gradients differ), while the reference
runs in the test process.

* Two ranks, one spawn: whisper-small fal and preln (2 + 2 layers),
  zamba2-1.2b fal at 5 layers (two groups of two and a trailing layer) and
  mamba2-370m.  Logits, loss, every gradient leaf after ``tp_sync_grads``
  (the ranks' shards joined by ``launch.mesh.gather_params``) and one
  AdamW step (clipped, decay on) against the reference; 8 greedy
  ``make_serve_step`` ticks (whisper's after ``whisper_encode``) token for
  token; the zamba2 and mamba2 ``ContinuousBatcher`` (2 slots, 4 requests:
  two slots reused) against the reference's lone ``decode_step`` loop of
  each request.  The collectives, exactly: forward all-reduces whisper fal
  (L_enc + 1) + 3 L_dec, preln 2 L_enc + 3 L_dec, zamba2 fal n_groups + 1,
  mamba2 none; backward the same plus whisper's one *f* on the encoder's
  output; a decode tick the decoder's share.
* Four ranks (tp 2 x dp 2, FSDP over the data group), the second spawn:
  zamba2 fal's losses, gradient norms, first-step gradients and params
  after 2 steps against the reference's one device.
* The launcher (``python -m repro_torch.launch.train --tp explicit``) on
  two gloo ranks for each family: the one-device trainer's final loss.

Tolerances, those of ``test_torch_tp.py``: logits and loss 1e-5, gradients
1e-6 plus 1e-4 of the leaf's largest value, post-step params as
``test_torch_train.py``'s ``_close_step``, grad norms 1e-5 relative.
"""
import concurrent.futures

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.launch import mesh as RMX  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.serve import decode as RD  # noqa: E402
from repro.train import step as RT  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402

import torch_family_tp_ranks as FR  # noqa: E402
import torch_tp_ranks as R  # noqa: E402
from test_torch_fsdp import _whole  # noqa: E402
from test_torch_ssm import _lone  # noqa: E402
from test_torch_train import _close_step, _close_tree  # noqa: E402

OCFG = dict(lr=3e-4, weight_decay=0.5, clip_norm=0.05)
B, S, TICKS = 2, 32, 8
#: {case: config kwargs of ``family_config``}
CASES = {"whisper_fal": dict(arch="whisper-small", connection="fal"),
         "whisper_preln": dict(arch="whisper-small", connection="preln"),
         "zamba_fal": dict(arch="zamba2-1.2b", connection="fal", n_layers=5),
         "mamba": dict(arch="mamba2-370m")}
BATCHERS = ("zamba_fal", "mamba")
#: the FSDP world: (world, tp size), steps, global batch, its floor
FSDP_WORLD, FSDP_STEPS, FSDP_B, FSDP_S, FLOOR = (4, 2), 2, 4, 16, 32


def _ref_cfg(arch, **kw):
    return ref_config(arch).reduced().replace(**kw)


def _weights(rcfg, seed):
    """The reference's ``init_params`` with every norm's scale redrawn as
    1 + 0.1 normal and its bias as 0.1 normal (numpy)."""
    params = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), rcfg)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.asarray(leaf)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        return {"scale": 1 + 0.1 * z, "bias": 0.1 * z}.get(name, leaf)
    return jax.tree_util.tree_map_with_path(draw, params)


def _batch(rcfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)}
    if rcfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, rcfg.n_enc_frames, rcfg.d_model)).astype(np.float32)
    return out


def _reference(rcfg, params, batch, ocfg):
    """Logits, loss and gradients of the reference's one device, and its
    state and metrics after one train step."""
    rb = {k: jnp.asarray(v) for k, v in batch.items()}

    def run(p):
        value, grads = jax.value_and_grad(
            lambda q: RM.loss_fn(q, rcfg, rb)[0])(p)
        return RM.forward(p, rcfg, rb)[0], value, grads
    logits, value, grads = jax.jit(run)(params)
    step = jax.jit(RT.make_train_step(rcfg, ocfg))
    state, m = step({"params": params,
                     "opt": RO.init_opt_state(params, ocfg)}, rb)
    return {"logits": np.asarray(logits), "loss": float(value),
            "grads": jax.tree.map(np.asarray, grads), "state": state,
            "metrics": {k: float(v) for k, v in m.items()}}


_ref_step = jax.jit(RM.decode_step, static_argnums=(1, 4))


def _ref_decode(rcfg, params, prompt, frames):
    """The reference's greedy ticks from ``prompt`` at position 0."""
    cache = RM.init_cache(rcfg, B, TICKS + 2, "float32")
    if frames is not None:
        cache = dict(cache, enc_out=RM.whisper_encode(params, rcfg,
                                                      jnp.asarray(frames)))
    tok, toks = jnp.asarray(prompt[:, None]), []
    for t in range(TICKS):
        logits, cache = _ref_step(params, rcfg,
                                  {"tokens": tok,
                                   "pos": jnp.full((B,), t, jnp.int32)},
                                  cache, None)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok[:, 0]))
    return np.stack(toks, 1)


def _requests(rcfg):
    rng = np.random.default_rng(8)
    return [(i, rng.integers(0, rcfg.vocab, 6 + i), 5 + 2 * i)
            for i in range(4)]


def _fsdp_reference(rcfg, params, toks, ocfg):
    """The one device's first-step gradients and its metrics and params
    after ``FSDP_STEPS`` steps over the global batches."""
    grads = jax.jit(jax.grad(lambda p: RM.loss_fn(
        p, rcfg, {"tokens": jnp.asarray(toks[0])})[0]))(params)
    step = jax.jit(RT.make_train_step(rcfg, ocfg))
    state = {"params": params, "opt": RO.init_opt_state(params, ocfg)}
    metrics = []
    for t in toks[:FSDP_STEPS]:
        state, m = step(state, {"tokens": jnp.asarray(t)})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, grads), metrics, state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rcfgs = {n: _ref_cfg(**kw) for n, kw in CASES.items()}
    weights = {n: _weights(c, i) for i, (n, c) in enumerate(rcfgs.items())}
    batches = {n: _batch(c, 10 + i) for i, (n, c) in enumerate(rcfgs.items())}
    prompts = {n: np.random.default_rng(20 + i).integers(
        0, c.vocab, (B,)).astype(np.int32)
        for i, (n, c) in enumerate(rcfgs.items())}
    reqs = {n: _requests(rcfgs[n]) for n in BATCHERS}
    zamba = rcfgs["zamba_fal"]
    fsdp_toks = np.random.default_rng(30).integers(
        0, zamba.vocab, (FSDP_STEPS, FSDP_B, FSDP_S)).astype(np.int32)

    def spawn():
        two = tp.run_ranks(
            "torch_family_tp_ranks:family_parity", 2, backend="gloo",
            threads=1, timeout=R.RANKS_TIMEOUT,
            workdir=str(tmp_path_factory.mktemp("family_tp")),
            args=({n: (CASES[n], weights[n], batches[n], prompts[n])
                   for n in CASES}, OCFG, TICKS,
                  {n: (CASES[n], weights[n], reqs[n], 2, 32)
                   for n in BATCHERS}))
        world, tp_size = FSDP_WORLD
        four = tp.run_ranks(
            "torch_family_tp_ranks:family_fsdp", world, backend="gloo",
            threads=1, timeout=R.RANKS_TIMEOUT, tp_size=tp_size,
            workdir=str(tmp_path_factory.mktemp("family_fsdp")),
            args=(CASES["zamba_fal"], weights["zamba_fal"], fsdp_toks, OCFG,
                  FSDP_STEPS, FLOOR))
        return two, four

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn)
        ocfg = RO.AdamWConfig(**OCFG)
        ref = {n: _reference(c, weights[n], batches[n], ocfg)
               for n, c in rcfgs.items()}
        for n, c in rcfgs.items():
            ref[n]["decode"] = _ref_decode(c, weights[n], prompts[n],
                                           batches[n].get("frames"))
        lone = {n: {rid: _lone(weights[n], rcfgs[n], p, m, 32)
                    for rid, p, m in reqs[n]} for n in BATCHERS}
        fsdp = _fsdp_reference(zamba, weights["zamba_fal"], fsdp_toks, ocfg)
        two, four = ranks.result()
        return {"ref": ref, "ranks": two, "lone": lone, "fsdp_ref": fsdp,
                "fsdp": four}


def _cfg(name):
    return FR.family_config(**CASES[name])


def _expected_forward(name):
    """Forward all-reduces of a full-sequence pass (and of a decode tick)
    by the formulas of the blocks' paths."""
    cfg = _cfg(name)
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        tick = groups + 1 if cfg.connection == "fal" else 2 * groups
        return tick, tick
    enc = cfg.n_enc_layers + 1 if cfg.connection == "fal" \
        else 2 * cfg.n_enc_layers
    return enc + 3 * cfg.n_layers, 3 * cfg.n_layers


@pytest.mark.parametrize("name", CASES)
def test_logits_loss_and_gradients_match_reference(run, name):
    ref = run["ref"][name]
    ranks = [r[name] for r in run["ranks"]]
    for r in ranks:               # the logits are replicated on every rank
        np.testing.assert_allclose(r["logits"].numpy(), ref["logits"],
                                   atol=1e-5, rtol=0)
        assert abs(r["loss"] - ref["loss"]) <= 1e-5
    cfg = _cfg(name)
    _close_tree(ref["grads"], MX.gather_params([r["grads"] for r in ranks],
                                               cfg), cfg, 1e-6, 1e-4)


@pytest.mark.parametrize("name", CASES)
def test_one_adamw_step_matches_reference(run, name):
    ref = run["ref"][name]
    assert ref["metrics"]["grad_norm"] > OCFG["clip_norm"]
    ranks = [r[name] for r in run["ranks"]]
    for r in ranks:
        got = r["step_metrics"]
        assert abs(got["loss"] - ref["metrics"]["loss"]) <= 1e-5
        assert abs(got["grad_norm"] - ref["metrics"]["grad_norm"]) \
            <= 1e-5 * ref["metrics"]["grad_norm"]
    cfg = _cfg(name)
    full = {"params": MX.gather_params([r["step"] for r in ranks], cfg)}
    _close_step(ref["state"], full, cfg, OCFG["lr"])


@pytest.mark.parametrize("name", CASES)
def test_greedy_decode_matches_reference(run, name):
    want = run["ref"][name]["decode"]
    cfg = _cfg(name)
    for r in run["ranks"]:
        dec = r[name]["decode"]
        np.testing.assert_array_equal(dec["tokens"].numpy(), want)
        # a rank's K / V heads (the reference's ``cache_specs``), the
        # recurrent state and ``enc_out`` whole
        for path, shape in dec["cache_shapes"].items():
            if path[-1] in ("k", "v"):
                assert shape[-2] == cfg.n_kv_heads // 2, path
            if path[-1] == "enc_out":
                assert shape == (B, cfg.n_enc_frames, cfg.d_model)
    for a, b in zip(*(r[name]["decode"]["logits"] for r in run["ranks"])):
        assert torch.equal(a, b)                  # in lockstep, bit-equal


@pytest.mark.parametrize("name", CASES)
def test_all_reduce_counts_follow_the_blocks_paths(run, name):
    """Forward all-reduces exactly the formula; the backward the same plus
    whisper's *f* on the encoder's output; the step's sync one all-reduce
    where a replicated leaf's gradient is partial (the encoder's and the
    fused shared block's ``ln1`` / ``ln2`` under fal), none else; each
    decode tick the decoder's share; nothing else moves."""
    cfg = _cfg(name)
    fwd, tick = _expected_forward(name)
    audio = cfg.family == "audio"
    sync = int(cfg.connection == "fal" and cfg.family != "ssm")
    for r in run["ranks"]:
        res = r[name]
        assert tp.count(res["forward"], "all-reduce") == fwd
        assert set(res["forward"]) <= {"all-reduce"}
        tr = res["train"]
        assert tp.count(tr, "all-reduce") == fwd
        assert tp.count(tr, "all-reduce", "backward") == fwd + audio
        assert tp.count(tr, "all-reduce", "step") == sync
        dec = res["decode"]
        assert all(tp.count(c, "all-reduce") == tick for c in dec["counts"])
        if audio:
            enc = cfg.n_enc_layers + 1 if cfg.connection == "fal" \
                else 2 * cfg.n_enc_layers
            assert tp.count(dec["encode"], "all-reduce") == enc
    if cfg.family == "ssm":
        assert all(not r[name]["train"] for r in run["ranks"])


@pytest.mark.parametrize("name", BATCHERS)
def test_batcher_reused_slots_match_lone_reference_streams(run, name):
    """2 slots and 4 requests a rank, in lockstep: each stream equals the
    reference's lone ``decode_step`` loop of the request (the reused
    slots' recurrent leaves zeroed), on both ranks."""
    want = run["lone"][name]
    cfg = _cfg(name)
    tick = _expected_forward(name)[1]
    for r in run["ranks"]:
        got = r[f"batcher_{name}"]
        assert got["streams"] == want
        assert tp.count(got["counts"], "all-reduce") == tick * got["ticks"]
    assert cfg.family in ("ssm", "hybrid")


def test_zamba_tp_by_dp_fsdp_matches_one_device(run, monkeypatch):
    """tp 2 x dp 2, FSDP over the data group (its floor lowered in both
    packages): losses and grad norms of 2 steps, the first step's
    gradients (every data and TP rank's slices joined) and the params after
    the steps against the reference's one device."""
    monkeypatch.setattr(MX, "FSDP_MIN_DIM", FLOOR)
    monkeypatch.setattr(RMX, "_FSDP_MIN_DIM", FLOOR)
    grads, metrics, state = run["fsdp_ref"]
    ranks = run["fsdp"]
    cfg = _cfg("zamba_fal")
    assert MX.fsdp_layout(cfg, 2, 2)            # something is sliced
    for r in ranks:
        for got, want in zip(r["metrics"], metrics):
            assert abs(got["loss"] - want["loss"]) <= 1e-5, (got, want)
            assert abs(got["grad_norm"] - want["grad_norm"]) \
                <= 1e-5 * want["grad_norm"], (got, want)
    _close_tree(grads, _whole(ranks, cfg, lambda r: r["grads"]), cfg, 1e-6,
                1e-4)
    _close_step(state, {"params": _whole(ranks, cfg, lambda r: r["params"])},
                cfg, OCFG["lr"] * FSDP_STEPS)


def test_reference_batcher_first_tenants_agree(run):
    """The reference batcher's streams of the slots' first tenants (its
    reused slots carry the last request's state, ROADMAP.md Queue 3) equal
    the port's TP streams."""
    for name in BATCHERS:
        rcfg = _ref_cfg(**CASES[name])
        params = _weights(rcfg, list(CASES).index(name))
        eng = RD.ContinuousBatcher(rcfg, params, batch_slots=2, max_seq=32)
        for rid, p, m in _requests(rcfg):
            eng.submit(RD.Request(rid=rid, prompt=p, max_new=m))
        ref = {r.rid: r.generated for r in eng.run()}
        got = run["ranks"][0][f"batcher_{name}"]["streams"]
        assert all(got[rid] == ref[rid] for rid in (0, 1)), name


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b",
                                  "whisper-small"])
def test_launcher_trains_each_family_under_two_ranks(arch, tmp_path):
    """``python -m repro_torch.launch.train --tp explicit`` on two gloo
    ranks (whisper's batches with ``data.pipeline.stub_frames``): both
    ranks print the one-device trainer's final loss of the seed."""
    import sys
    from repro_torch.configs.base import get_config
    from repro_torch.train import trainer
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            arch, "--reduced", "--steps", "2", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--tp", "explicit", "--backend", "gloo",
            "--init-method", f"file://{tmp_path}/store"]
    logs = tp.spawn(argv, 2, workdir=str(tmp_path / "ranks"), threads=1,
                    timeout=R.RANKS_TIMEOUT)
    finals = [[ln for ln in log.splitlines() if ln.startswith("final loss")]
              for log in logs]
    assert finals[0] == finals[1] and len(finals[0]) == 1, logs
    assert "tp=explicit x2" in logs[0]
    _, hist = trainer.train(get_config(arch).reduced(), steps=2, batch=2,
                            seq_len=32, device="cpu", log_every=0)
    assert abs(float(finals[0][0].split()[-1]) - hist[-1]["loss"]) <= 1e-4
