"""Parity of the PyTorch port's configs, plan, FAL modes and layers with the
JAX package: the same numpy inputs through both, fp32, tolerance 1e-5."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as RB  # noqa: E402
from repro.core import fal as RF  # noqa: E402
from repro.core import plan as RP  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import fal as TF  # noqa: E402
from repro_torch.core import plan as TP  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = 1e-5          # fp32 on both sides; sums taken in another order


def _close(jax_out, torch_out, tol=TOL):
    a = np.asarray(jax_out, np.float32)
    b = torch_out.detach().float().numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=tol, rtol=0)


def _norm_params(rng, d, kind):
    p = {"scale": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", RB.ARCH_IDS)
def test_config_matches_reference(arch):
    ref, port = RB.get_config(arch), TB.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    if ref.n_heads:                 # mamba2 has no attention heads
        assert port.resolved_head_dim == ref.resolved_head_dim


def test_config_registry_matches_reference():
    assert TB.ARCH_IDS == RB.ARCH_IDS
    assert TB.VALID_CONNECTIONS == RB.VALID_CONNECTIONS
    assert {k: dataclasses.asdict(v) for k, v in TB.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in RB.INPUT_SHAPES.items()}
    over = dict(n_layers=3, connection="falplus")
    assert dataclasses.asdict(TB.get_config("gpt2-117m", **over)) == \
        dataclasses.asdict(RB.get_config("gpt2-117m", **over))


# --------------------------------------------------------------------- plan
def test_plan_resolve_and_phase():
    for v in (None, "paged", "train", TP.Phase.DECODE):
        rv = RP.Phase.DECODE if v is TP.Phase.DECODE else v
        assert TP.ExecutionPlan.resolve(v).phase.value == \
            RP.ExecutionPlan.resolve(rv).phase.value
    plan = TP.ExecutionPlan.single_device().with_phase("paged")
    assert plan.phase is TP.Phase.PAGED and not plan.full_sequence
    with pytest.raises(TypeError, match="context dicts"):
        TP.ExecutionPlan.resolve({"mode": "train"})
    with pytest.raises(ValueError) as port_err:
        TP.Phase.coerce("bogus")
    with pytest.raises(ValueError) as ref_err:
        RP.Phase.coerce("bogus")
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("arch,connection,phase", [
    ("llama3.2-3b", "preln", "paged"),       # must assemble
    ("llama3.2-3b", "fal", "train"),         # not a decode phase
    ("mamba2-370m", "fal", "decode"),        # family without the fork
    ("gemma2-27b", "fal", "paged"),          # post-norms
])
def test_plan_dual_branch_errors_match_reference(arch, connection, phase):
    def err(P, B):
        cfg = B.get_config(arch).replace(connection=connection)
        plan = P.ExecutionPlan.single_device(phase, dual_branch=True)
        with pytest.raises(ValueError) as e:
            plan.validate(cfg)
        return str(e.value)

    assert err(TP, TB) == err(RP, RB)


def test_plan_dual_branch_valid_for_fal():
    cfg = TB.get_config("llama3.2-3b")
    plan = TP.ExecutionPlan.single_device("paged", dual_branch=True)
    assert plan.validate(cfg) is plan


# ---------------------------------------------------------------------- fal
def test_fal_predicates_match_reference():
    assert TF.DUAL_BRANCH_MODES == RF.DUAL_BRANCH_MODES
    assert TF.NEEDS_LN_FAL == RF.NEEDS_LN_FAL
    assert TF.USES_FIRST_ATTENTION == RF.USES_FIRST_ATTENTION
    for mode in RB.VALID_CONNECTIONS:
        assert TF.mlp_input_depends_on_local_attention(mode) == \
            RF.mlp_input_depends_on_local_attention(mode)
        for b0 in (False, True):
            assert TF.attention_must_assemble(mode, b0) == \
                RF.attention_must_assemble(mode, b0)


@pytest.mark.parametrize("mode", RB.VALID_CONNECTIONS)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_mlp_input_matches_reference(mode, norm):
    rng = np.random.default_rng(1)
    d = 48
    x, a, sig = (rng.standard_normal((2, 5, d)).astype(np.float32)
                 for _ in range(3))
    tree = {n: _norm_params(rng, d, norm) for n in ("ln2", "ln_fal", "ln_a")}
    jp = {k: _both(v)[0] for k, v in tree.items()}
    tp = {k: _both(v)[1] for k, v in tree.items()}
    rcfg = RB.get_config("llama3.2-3b").replace(connection=mode, norm=norm)
    tcfg = TB.get_config("llama3.2-3b").replace(connection=mode, norm=norm)
    J = [jnp.asarray(v) for v in (x, a, sig)]
    T = [torch.from_numpy(v) for v in (x, a, sig)]
    _close(RF.mlp_input(rcfg, jp, *J), TF.mlp_input(tcfg, tp, *T))
    _close(RF.block0_mlp_input(rcfg, jp, J[0], J[1]),
           TF.block0_mlp_input(tcfg, tp, T[0], T[1]))
    rs = RF.first_attention_signal(rcfg, jp, J[1])
    ts = TF.first_attention_signal(tcfg, tp, T[1])
    assert (rs is None) == (ts is None)
    if rs is not None:
        _close(rs, ts)


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply_matches_reference(kind):
    rng = np.random.default_rng(2)
    x = (3.0 * rng.standard_normal((4, 6, 64)) + 0.5).astype(np.float32)
    jp, tp = _both(_norm_params(rng, 64, kind))
    _close(RL.norm_apply(jp, jnp.asarray(x), kind),
           TL.norm_apply(tp, torch.from_numpy(x), kind))


def test_norm_apply_keeps_dtype_and_fp32_compute():
    x = torch.randn(3, 16, dtype=torch.float32).to(torch.bfloat16)
    p = {"scale": torch.ones(16)}
    y = TL.norm_apply(p, x)
    assert y.dtype == torch.bfloat16
    ref = RL.norm_apply({"scale": jnp.ones(16)},
                        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 7)).astype(np.int32)
    _close(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta))
    np.testing.assert_array_equal(TL.rope_freqs(32, theta).numpy(),
                                  np.asarray(RL.rope_freqs(32, theta)))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches_reference(kind):
    rng = np.random.default_rng(4)
    d, f = 32, 80
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {"wi": rng.standard_normal((d, f)).astype(np.float32) / np.sqrt(d),
         "wo": rng.standard_normal((f, d)).astype(np.float32) / np.sqrt(f)}
    if kind != "gelu":
        p["wg"] = rng.standard_normal((d, f)).astype(np.float32) / np.sqrt(d)
    jp, tp = _both(p)
    _close(RL.mlp_apply(jp, jnp.asarray(x), kind),
           TL.mlp_apply(tp, torch.from_numpy(x), kind))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_embed_unembed_softcap_match_reference(cap):
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, (2, 6)).astype(np.int32)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32) * 4
    jp, tp = {"emb": jnp.asarray(emb)}, {"emb": torch.from_numpy(emb)}
    _close(RL.embed_apply(jp, jnp.asarray(tok), "float32"),
           TL.embed_apply(tp, torch.from_numpy(tok), torch.float32))
    _close(RL.unembed_apply(jp, jnp.asarray(x), cap),
           TL.unembed_apply(tp, torch.from_numpy(x), cap))
    _close(RL.softcap(jnp.asarray(x), cap),
           TL.softcap(torch.from_numpy(x), cap))
