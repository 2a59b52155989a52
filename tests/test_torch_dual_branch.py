"""Dual-branch (MHA||MLP) decode in the port: the fused kernel's plain
version against the JAX package's fused Pallas kernel (interpret mode), the
dispatcher's route rule, the port's dual-branch padded ticks bit-identical
to its sequential ones on the CPU, and (on a card only) the CUDA kernel
against the plain version."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.kernels import ops as ROPS  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import fal  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.kernels import dual_branch as DB  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = 1e-5          # fp32 on both sides; sums in another order
DUAL_MODES = ("fal", "parallel", "ablation2")


def _t(a):
    return torch.from_numpy(np.array(a))


def _fused_case(kind, F=256, seed=9):
    """The shapes of tests/test_dual_branch.py:231."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    B, H, Hkv, D, page, T, Dm = 2, 8, 2, 32, 8, 4, 64
    q = jax.random.normal(ks[0], (B, H, D))
    kp = jax.random.normal(ks[1], (T * B + 2, page, Hkv, D))
    vp = jax.random.normal(ks[2], (T * B + 2, page, Hkv, D))
    bt = jnp.asarray(np.arange(1, 1 + B * T).reshape(B, T), jnp.int32)
    sl = jnp.asarray([(T - 1) * page + 3, page], jnp.int32)
    x = jax.random.normal(ks[3], (B, 1, Dm))
    ffn = RL.mlp_init(ks[4], Dm, F, kind)
    return (q, kp, vp, bt, sl), x, ffn


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_fused_plain_matches_pallas_interpret(kind):
    att, x, ffn = _fused_case(kind)
    a, y = ROPS.dual_branch_decode(*att, x, ffn, kind=kind, interpret=True)
    ta, ty = DB.fused_dual_branch_decode(
        *map(_t, att), _t(x)[:, 0], {k: _t(v) for k, v in ffn.items()},
        kind=kind)
    np.testing.assert_allclose(ta.numpy(), np.asarray(a), atol=TOL, rtol=0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y)[:, 0], atol=TOL,
                               rtol=0)
    # and against the reference's oracle pair (ref attention + mlp_apply)
    np.testing.assert_allclose(ta.numpy(),
                               np.asarray(RREF.paged_attention_ref(*att)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(ty.numpy(),
                               np.asarray(RL.mlp_apply(ffn, x, kind))[:, 0],
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("F,fused", [(256, True), (98, False)])
def test_dispatcher_route_rule(monkeypatch, F, fused):
    """F % (Hkv * Tb) == 0 takes the fused kernel; otherwise the decode
    kernel and mlp_apply (Hkv * Tb = 8 here), as repro/kernels/ops.py:222
    routes; both match the reference's dispatcher."""
    att, x, ffn = _fused_case("gelu", F=F)
    calls = []
    for mod, name in ((DB, "fused_dual_branch_decode"),
                      (PA, "paged_decode_attention")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    ops.reset_dispatch_paths()
    a, y = ops.dual_branch_decode(*map(_t, att), _t(x),
                                  {k: _t(v) for k, v in ffn.items()},
                                  kind="gelu")
    assert calls == (["fused_dual_branch_decode"] if fused
                     else ["paged_decode_attention"])
    assert ops.dispatch_paths() == {"dual_branch_decode": ops.PLAIN}
    ra, ry = ROPS.dual_branch_decode(*att, x, ffn, kind="gelu",
                                     interpret=True)
    assert y.shape == (2, 1, 64)
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), atol=TOL, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=5e-5, rtol=0)


def test_fused_wrapper_rejects_what_the_kernel_does_not_take():
    att, x, ffn = _fused_case("swiglu")
    args = (*map(_t, att), _t(x)[:, 0], {k: _t(v) for k, v in ffn.items()})
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        DB.check_kernel_args(*args, "swiglu")
    with pytest.raises(ValueError, match="CUDA"):
        DB.fused_dual_branch_decode_cuda(*args)


# --------------------------------------------------------------------------- #
# the port's dual-branch padded ticks equal its sequential ones, bit for bit
# --------------------------------------------------------------------------- #
def _port_logits(cfg, params, toks, chunk, *, dual, cache_dtype="float32",
                 page=8, num_pages=24):
    """``tests/test_dual_branch.py:33`` ``_paged_logits`` on the port: drive
    the padded ``paged_decode_step`` over ``toks`` in chunks."""
    B, S = toks.shape
    Tb = -(-S // page)
    plan = ExecutionPlan.single_device("paged", dual_branch=dual)
    cache = TM.init_paged_cache(cfg, num_pages, page, B, cache_dtype,
                                device="cpu")
    bt = torch.arange(1, 1 + B * Tb, dtype=torch.int32).reshape(B, Tb)
    outs, t = [], 0
    while t < S:
        nv = min(chunk, S - t)
        padded = torch.zeros((B, chunk), dtype=torch.int32)
        padded[:, :nv] = torch.from_numpy(toks[:, t:t + nv])
        lg, cache = TM.paged_decode_step(
            params, cfg, {"tokens": padded,
                          "pos": torch.full((B,), t, dtype=torch.int32),
                          "n_valid": torch.full((B,), nv, dtype=torch.int32),
                          "block_tables": bt}, cache, plan)
        outs.append(lg[:, :nv])
        t += nv
    return torch.cat(outs, 1)


def _port_model(connection, seed=0):
    cfg = get_config("llama3.2-3b").reduced().replace(connection=connection)
    return cfg, TM.init_params(cfg, seed=seed, device="cpu")


@pytest.mark.parametrize("chunk", [1, 5])
@pytest.mark.parametrize("mode", DUAL_MODES)
def test_port_dual_bit_exact(mode, chunk):
    cfg, params = _port_model(mode)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    ops.reset_dispatch_paths()
    seq = _port_logits(cfg, params, toks, chunk, dual=False)
    dual = _port_logits(cfg, params, toks, chunk, dual=True)
    assert torch.equal(seq, dual), (seq - dual).abs().max().item()
    want = {"paged_decode_attention", "dual_branch_decode"} if chunk == 1 \
        else {"paged_chunk_attention"}
    if mode in fal.FUSED_LN_ADD_MODES:
        want.add("fused_ln_add")
    assert set(ops.dispatch_paths()) == want


def test_port_dual_bit_exact_reduced_cache_dtype():
    """Active lanes read this tick's fresh activation-dtype signal, not the
    bf16-rounded cached one (the regression test_dual_branch.py:77 guards
    in the JAX suite)."""
    cfg, params = _port_model("fal")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    seq = _port_logits(cfg, params, toks, 1, dual=False,
                       cache_dtype="bfloat16")
    dual = _port_logits(cfg, params, toks, 1, dual=True,
                        cache_dtype="bfloat16")
    assert torch.equal(seq, dual)


def test_port_dual_idle_lanes_read_their_cached_signal():
    """On a C == 1 dual tick a lane with n_valid == 0 feeds its held
    per-slot a1_sig to the later blocks' MLPs, so its (meaningless) row
    differs from the sequential tick's while the active lanes' rows stay
    bit-identical."""
    cfg, params = _port_model("fal")
    rng = np.random.default_rng(2)
    cache = TM.init_paged_cache(cfg, 12, 4, 3, "float32", device="cpu")
    for part in ("block0", "blocks"):
        for name in ("k", "v"):
            cache[part][name].copy_(torch.from_numpy(rng.standard_normal(
                cache[part][name].shape).astype(np.float32)))
    cache["a1_sig"].copy_(torch.from_numpy(rng.standard_normal(
        cache["a1_sig"].shape).astype(np.float32)))
    batch = {"tokens": torch.tensor([[3], [5], [7]], dtype=torch.int32),
             "pos": torch.tensor([4, 9, 2], dtype=torch.int32),
             "n_valid": torch.tensor([1, 0, 1], dtype=torch.int32),
             "block_tables": torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]],
                                          dtype=torch.int32)}
    outs = {}
    for dual in (False, True):
        c = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                 else v.clone()) for k, v in cache.items()}
        outs[dual], c = TM.paged_decode_step(
            params, cfg, batch, c,
            ExecutionPlan.single_device("paged", dual_branch=dual))
        assert torch.equal(c["a1_sig"][1], cache["a1_sig"][1])
    assert torch.equal(outs[False][[0, 2]], outs[True][[0, 2]])
    assert not torch.equal(outs[False][1], outs[True][1])


@pytest.mark.cuda
def test_fused_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for kind, F, dtype in ((k, f, d) for k in DB.KINDS for f in (256, 200)
                           for d in (torch.float32, torch.bfloat16)):
        att, x, ffn = _fused_case(kind, F=F)
        att = [_t(a).cuda() for a in att]
        q, kp, vp = (a.to(dtype) for a in att[:3])
        xs = _t(x)[:, 0].cuda().to(dtype)
        w = {k: _t(v).cuda().to(dtype) for k, v in ffn.items()}
        a, y = DB.fused_dual_branch_decode(q, kp, vp, *att[3:], xs, w,
                                           kind=kind)
        ra, ry = DB.fused_dual_branch_decode_plain(
            q.float(), kp.float(), vp.float(), *att[3:], xs.float(),
            {k: v.float() for k, v in w.items()}, kind=kind)
        torch.cuda.synchronize()
        # fp32: sums in another order; bf16: one rounding of each output
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert (a.float() - ra.to(dtype).float()).abs().max().item() <= tol
        assert (y.float() - ry.to(dtype).float()).abs().max().item() <= tol


def test_preln_dual_tick_raises_like_reference():
    """preln cannot run dual-branch: the port's plan raises the
    reference's ValueError before any kernel runs."""
    cfg = get_config("llama3.2-3b").reduced().replace(connection="preln")
    plan = ExecutionPlan.single_device("paged", dual_branch=True)
    with pytest.raises(ValueError, match="must assemble MHA"):
        TM.paged_decode_step({}, cfg, {"tokens": None}, {}, plan)
