"""The port's padded (B, C) paged tick against the JAX package: one
``paged_decode_step`` tick from the same weights, cache and batch (C == 1
and C > 1, ragged ``n_valid``, idle lanes), sequential and dual-branch, and
a 12-token generation loop as ``tests/test_dual_branch.py:33`` drives it.
fp32 on both sides; hidden states, logits, the per-slot ``a1_sig`` and the
written K/V pools agree within 1e-4 (a few layers of fp32 matmuls summed in
another order, activations of order 1)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.core.plan import ExecutionPlan as RPlan  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.plan import ExecutionPlan as TPlan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = 1e-4
_init = jax.jit(RM.init_params, static_argnums=1)
#: per-lane (pos, n_valid) of a tick: ragged lanes and an idle lane
LANES = {1: ((3, 1), (9, 1), (2, 0), (14, 1)),
         6: ((0, 6), (5, 3), (11, 0), (2, 1))}


def _models(arch, connection):
    rcfg = ref_config(arch).reduced().replace(connection=connection)
    tcfg = get_config(arch).reduced().replace(connection=connection)
    rparams = _init(jax.random.PRNGKey(1), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def _tick(arch, connection, C, dual, want="hidden"):
    rcfg, rparams, tcfg, tparams = _models(arch, connection)
    rng = np.random.default_rng(C)
    page, Tb, P = 4, 5, 24
    lanes = LANES[C]
    B = len(lanes)
    rc = RM.init_paged_cache(rcfg, P, page, B, "float32")
    rc = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), rc)
    tc = TM.init_paged_cache(tcfg, P, page, B, "float32", device="cpu")
    for part in ("block0", "blocks"):
        for name in ("k", "v"):
            tc[part][name].copy_(torch.from_numpy(np.array(rc[part][name])))
    tc["a1_sig"].copy_(torch.from_numpy(np.array(rc["a1_sig"])))
    batch = dict(
        tokens=rng.integers(0, rcfg.vocab, (B, C)).astype(np.int32),
        pos=np.array([p for p, _ in lanes], np.int32),
        n_valid=np.array([n for _, n in lanes], np.int32),
        block_tables=rng.permutation(np.arange(1, P))[:B * Tb].reshape(
            B, Tb).astype(np.int32))
    r_out, r_c = RM.paged_decode_step(
        rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()}, rc,
        RPlan.single_device("paged", dual_branch=dual), want=want)
    ops.reset_dispatch_paths()
    t_out, t_c = TM.paged_decode_step(
        tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        tc, TPlan.single_device("paged", dual_branch=dual), want=want)
    live = np.arange(C)[None] < batch["n_valid"][:, None]
    return live, (np.asarray(r_out), r_c), (t_out.numpy(), t_c)


def _close(a, b):
    np.testing.assert_allclose(b, np.asarray(a), atol=TOL, rtol=0)


@pytest.mark.parametrize("C", [1, 6])
@pytest.mark.parametrize("connection,dual", [
    ("fal", False), ("fal", True), ("preln", False), ("parallel", True),
    ("falplus", False), ("ablation2", True)])
def test_padded_tick_matches_reference(connection, dual, C):
    live, (r_h, r_c), (t_h, t_c) = _tick("llama3.2-3b", connection, C, dual)
    assert t_h.shape == r_h.shape
    _close(r_h[live], t_h[live])
    _close(r_c["a1_sig"], t_c["a1_sig"].numpy())
    for part in ("block0", "blocks"):
        for name in ("k", "v"):
            # page 0 is scratch: rows past n_valid land there in any order
            _close(np.asarray(r_c[part][name])[..., 1:, :, :, :],
                   t_c[part][name].numpy()[..., 1:, :, :, :])
    paths = ops.dispatch_paths()
    if C > 1:
        assert paths == {"paged_chunk_attention": ops.PLAIN}
    elif dual:
        assert paths == {"paged_decode_attention": ops.PLAIN,
                         "dual_branch_decode": ops.PLAIN}
    else:
        assert paths == {"paged_decode_attention": ops.PLAIN}


@pytest.mark.parametrize("arch,connection", [
    ("gpt2-117m", "fal"),               # layernorm, gelu, learned positions
    ("qwen3-4b", "parallel"),           # qk_norm
    ("minicpm-2b", "fal")])             # G = 1
def test_padded_tick_logits_match_reference(arch, connection):
    for C in (1, 6):
        live, (r_l, r_c), (t_l, t_c) = _tick(arch, connection, C, True,
                                             want="logits")
        _close(r_l[live], t_l[live])
        _close(r_c["a1_sig"], t_c["a1_sig"].numpy())


def _drive(step, B, S, chunk, page=8):
    """Feed S tokens per lane in chunks of ``chunk``; ``step(tokens, pos,
    n_valid, block_tables) -> logits`` as numpy.  Returns the valid
    logits (B, S, V)."""
    Tb = -(-S // page)
    bt = np.arange(1, 1 + B * Tb, dtype=np.int32).reshape(B, Tb)
    outs, t = [], 0
    while t < S:
        nv = min(chunk, S - t)
        lg = step(t, nv, bt)
        outs.append(lg[:, :nv])
        t += nv
    return np.concatenate(outs, 1)


@pytest.mark.parametrize("connection,dual,chunk", [
    ("fal", False, 1), ("fal", True, 1), ("preln", False, 1),
    ("parallel", True, 1), ("fal", False, 5), ("fal", True, 5)])
def test_generation_loop_matches_reference(connection, dual, chunk):
    """``_paged_logits`` of tests/test_dual_branch.py:33 on both packages."""
    rcfg, rparams, tcfg, tparams = _models("llama3.2-3b", connection)
    B, S = 2, 12
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (B, S)) \
        .astype(np.int32)
    rplan = RPlan.single_device("paged", dual_branch=dual)
    tplan = TPlan.single_device("paged", dual_branch=dual)
    caches = {"r": RM.init_paged_cache(rcfg, 24, 8, B, "float32"),
              "t": TM.init_paged_cache(tcfg, 24, 8, B, "float32",
                                       device="cpu")}
    rstep = jax.jit(lambda b, c: RM.paged_decode_step(rparams, rcfg, b, c,
                                                      rplan))

    def batch(t, nv, bt):
        padded = np.zeros((B, chunk), np.int32)
        padded[:, :nv] = toks[:, t:t + nv]
        return dict(tokens=padded, pos=np.full((B,), t, np.int32),
                    n_valid=np.full((B,), nv, np.int32), block_tables=bt)

    def ref(t, nv, bt):
        lg, caches["r"] = rstep({k: jnp.asarray(v) for k, v in
                                 batch(t, nv, bt).items()}, caches["r"])
        return np.asarray(lg)

    def port(t, nv, bt):
        lg, caches["t"] = TM.paged_decode_step(
            tparams, tcfg, {k: torch.from_numpy(v) for k, v in
                            batch(t, nv, bt).items()}, caches["t"], tplan)
        return lg.numpy()

    _close(_drive(ref, B, S, chunk), _drive(port, B, S, chunk))


def test_paged_scatter_matches_reference():
    rng = np.random.default_rng(4)
    pages = rng.standard_normal((9, 4, 2, 8)).astype(np.float32)
    vals = rng.standard_normal((3, 5, 2, 8)).astype(np.float32)
    bt = np.array([[1, 2, 0], [3, 4, 5], [6, 7, 8]], np.int32)
    pos = np.array([2, 7, 0], np.int32)
    n_valid = np.array([5, 2, 0], np.int32)
    ref = RA.paged_scatter(*map(jnp.asarray, (pages, vals, bt, pos,
                                              n_valid)), 4)
    out = torch.from_numpy(pages.copy())
    ret = TA.paged_scatter(out, *map(torch.from_numpy, (vals, bt, pos,
                                                        n_valid)), 4)
    assert ret is out                           # updated in place
    np.testing.assert_array_equal(out.numpy()[1:], np.asarray(ref)[1:])
