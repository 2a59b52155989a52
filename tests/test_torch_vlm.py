"""The port's VLM decoder (llava-next-mistral-7b: the Mistral decoder with
an image prefix of precomputed patch embeddings) against the JAX
package's, on the CPU in fp32 at the reduced config (d 128, 4 / 2 heads,
16 image tokens), weights carried across with
``interop.params_from_numpy``:

* forward logits, ``loss_fn`` and every gradient with ``image_embeds``
  spliced over the first 16 positions (``_embed_tokens``);
* ``decode_step`` through the prefix (each tick's patch embedding in
  ``image_embeds``, as ``tests/test_decode_equiv.py:24-39`` drives it):
  every tick's logits equal the reference's and the port's own forward;
* a padded tick (a lane inside the prefix, one across its end, one past
  it, one idle) and a packed tick, each with per-row patch embeddings;
* explicit TP over two gloo ranks (``EXPLICIT_TP_FAMILIES`` takes the
  VLM), with and without SP, against the reference's single device;
* ``PagedEngine`` refuses a config with an image prefix, as the
  reference's does, and serves the same model as text with
  ``n_image_tokens = 0``.

Tolerances as ``test_torch_mla_model.py``'s (decode vs forward: the
reference's 2e-3)."""
import concurrent.futures

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
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.core.plan import ExecutionPlan as TPlan  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402

import test_torch_model as TMOD  # noqa: E402
import test_torch_tp as TTP  # noqa: E402
import torch_tp_ranks as R  # noqa: E402
from test_torch_train import _close_tree  # noqa: E402

ARCH = "llava-next-mistral-7b"
TOL = 1e-5
TICK_TOL = 1e-4


def _cfgs(**kw):
    return (ref_config(ARCH).reduced().replace(**kw),
            get_config(ARCH).reduced().replace(**kw))


def _close(want, got, tol=TICK_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


def _images(cfg, shape, seed=5):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def test_forward_loss_and_gradients_with_the_image_prefix():
    rcfg, tcfg = _cfgs()
    assert tcfg.n_image_tokens == 16
    params = TTP._weights(rcfg, 3)
    B, S = 2, 24
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (B, S)) \
        .astype(np.int32)
    img = _images(rcfg, (B, 16))
    batch = {"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)}

    def run(p):
        value, grads = jax.value_and_grad(
            lambda q: RM.loss_fn(q, rcfg, batch)[0])(p)
        return RM.forward(p, rcfg, batch)[0], value, grads
    r_logits, r_loss, r_grads = jax.jit(run)(params)
    tparams = interop.params_from_numpy(params, tcfg, "cpu",
                                        dtype="float32")
    for _, t in TO.named_leaves(tparams):
        t.requires_grad_(True)
    tb = {"tokens": torch.from_numpy(toks),
          "image_embeds": torch.from_numpy(img)}
    with torch.no_grad():
        logits = TM.forward(tparams, tcfg, tb)[0]
        plain = TM.forward(tparams, tcfg, {"tokens": tb["tokens"]})[0]
    loss, _ = TM.loss_fn(tparams, tcfg, tb)
    loss.backward()
    _close(r_logits, logits, TOL)
    assert (logits - plain).abs().max() > 1e-3       # the splice matters
    assert abs(float(loss.detach()) - float(r_loss)) <= TOL
    _close_tree(jax.tree.map(np.asarray, r_grads),
                TO.map_tree(lambda t: t.grad, tparams), tcfg, 1e-6, 1e-4)


def test_decode_step_through_the_prefix():
    """As ``tests/test_decode_equiv.py``: 32 ticks, tick t's patch
    embedding min(t, 15); the logits equal the reference's decode and the
    port's forward with the same prefix."""
    rcfg, tcfg = _cfgs()
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    B, S, n = 2, 32, tcfg.n_image_tokens
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (B, S)) \
        .astype(np.int32)
    img = _images(rcfg, (B, n))
    rc = RM.init_cache(rcfg, B, S, "float32")
    tc = TM.init_cache(tcfg, B, S, "float32", device="cpu")
    ref_step = jax.jit(lambda b, c: RM.decode_step(rparams, rcfg, b, c))
    r_out, t_out = [], []
    for t in range(S):
        i = min(t, n - 1)
        db = {"tokens": toks[:, t:t + 1],
              "pos": np.full((B,), t, np.int32),
              "image_embeds": img[:, i:i + 1]}
        lg, rc = ref_step({k: jnp.asarray(v) for k, v in db.items()}, rc)
        r_out.append(np.asarray(lg[:, 0]))
        lg, tc = TM.decode_step(tparams, tcfg,
                                {k: torch.from_numpy(v)
                                 for k, v in db.items()}, tc)
        t_out.append(lg[:, 0].numpy())
    _close(np.stack(r_out, 1), np.stack(t_out, 1))
    with torch.no_grad():
        full = TM.forward(tparams, tcfg, {
            "tokens": torch.from_numpy(toks),
            "image_embeds": torch.from_numpy(img)})[0]
    assert np.abs(np.stack(t_out, 1) - full.numpy()).max() < 2e-3


def _models():
    rcfg, tcfg = _cfgs()
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def test_padded_tick_splices_the_prefix():
    """Lanes at (pos, n_valid): inside the prefix (2, 6), across its end
    (13, 6), past it (20, 6), idle (0, 0)."""
    rcfg, rparams, tcfg, tparams = _models()
    rng = np.random.default_rng(2)
    lanes = ((2, 6), (13, 6), (20, 6), (0, 0))
    B, C, Tb, P = len(lanes), 6, 8, 40
    rc, tc = TMOD._filled_caches(rcfg, tcfg, rng, num_pages=P, slots=B)
    batch = dict(
        tokens=rng.integers(0, rcfg.vocab, (B, C)).astype(np.int32),
        pos=np.array([p for p, _ in lanes], np.int32),
        n_valid=np.array([nv for _, nv in lanes], np.int32),
        block_tables=rng.permutation(np.arange(1, P))[:B * Tb].reshape(
            B, Tb).astype(np.int32),
        image_embeds=_images(rcfg, (B, C)))
    r_l, r_c = RM.paged_decode_step(
        rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()}, rc,
        RPlan.single_device("paged"))
    t_l, t_c = TM.paged_decode_step(
        tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        tc, TPlan.single_device("paged"))
    live = np.arange(C)[None] < batch["n_valid"][:, None]
    _close(np.asarray(r_l)[live], t_l.numpy()[live])
    _close(r_c["a1_sig"], t_c["a1_sig"])


def test_packed_tick_splices_the_prefix():
    """``test_torch_model.py``'s packed batch (slot 0 prefills positions 0
    to 5 inside the prefix, slot 1 continues at 9 to 11, slot 2 decodes at
    20), each row with its patch embedding."""
    rcfg, rparams, tcfg, tparams = _models()
    rng = np.random.default_rng(3)
    rc, tc = TMOD._filled_caches(rcfg, tcfg, rng)
    batch = TMOD._packed_batch(rcfg, rng)
    batch["image_embeds"] = _images(rcfg, (len(batch["tokens"]),))
    r_l, r_c = RM.paged_decode_step(
        rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()}, rc)
    t_l, t_c = TM.paged_decode_step(
        tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        tc)
    live = batch["tok_pos"] >= 0
    _close(np.asarray(r_l)[0, live], t_l[0].numpy()[live])
    _close(r_c["a1_sig"], t_c["a1_sig"])
    for part in ("block0", "blocks"):
        for name in ("k", "v"):
            _close(r_c[part][name], t_c[part][name])


def test_tp_with_the_image_prefix_matches_reference(tmp_path):
    """fal at 4 layers over two gloo ranks, with and without SP: logits,
    loss and every gradient leaf against the reference's single device."""
    cfg = TTP._ref_cfg("fal", arch=ARCH)
    weights = TTP._weights(cfg, 9)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 512, (2, 24)).astype(np.int32),
             "image_embeds": _images(cfg, (2, 16))}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            tp.run_ranks, "torch_mla_ranks:tp_parity", 2, backend="gloo",
            threads=1, timeout=R.RANKS_TIMEOUT, workdir=str(tmp_path),
            args=(ARCH, {"fal": (dict(connection="fal"), weights)}, batch))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def run(p):
            value, grads = jax.value_and_grad(
                lambda q: RM.loss_fn(q, cfg, jb)[0])(p)
            return RM.forward(p, cfg, jb)[0], value, grads
        logits, loss, grads = jax.jit(run)(weights)
        ranks = ranks.result()
    tcfg = R.tp_config("fal", arch=ARCH)
    for sp in (False, True):
        got = [r[("fal", sp)] for r in ranks]
        for r in got:
            _close(logits, r["logits"], TOL)
            assert abs(r["loss"] - float(loss)) <= TOL
            assert tp.count(r["forward"], "all-reduce") == (1 if sp else 5)
        _close_tree(jax.tree.map(np.asarray, grads),
                    MX.gather_params([r["grads"] for r in got], tcfg),
                    tcfg, 1e-6, 1e-4)


def test_engine_refuses_an_image_prefix_like_reference():
    rcfg, rparams, tcfg, tparams = _models()
    with pytest.raises(NotImplementedError, match="text-only"):
        RS.PagedEngine(rcfg, rparams, RS.EngineConfig(page_size=8,
                                                      num_pages=16))
    with pytest.raises(NotImplementedError, match="text-only"):
        TS.PagedEngine(tcfg, tparams, TS.EngineConfig(page_size=8,
                                                      num_pages=16),
                       device="cpu")
    # the same model served as text (tests/test_serving.py:365)
    ecfg = dict(page_size=8, num_pages=32, slots=2, prefill_chunk=8,
                max_seq=64, cache_dtype="float32")
    out = []
    for mod, cfg, params in ((RS, rcfg, rparams), (TS, tcfg, tparams)):
        kw = {"device": "cpu"} if mod is TS else {}
        eng = mod.PagedEngine(cfg.replace(n_image_tokens=0), params,
                              mod.EngineConfig(**ecfg), **kw)
        rng = np.random.default_rng(6)
        for rid in range(3):
            eng.submit(mod.ServeRequest(rid=rid, prompt=rng.integers(
                0, 512, 5 + rid), max_new=5))
        out.append({r.rid: list(map(int, r.generated)) for r in eng.run()})
    assert out[0] == out[1]
