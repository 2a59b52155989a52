"""The port's §3 motivation analyses (``repro_torch.core.analysis``) against
the JAX package's (``repro.core.analysis``), on the CPU: the same numpy
weights in the reference's layout (``test_torch_tp._weights``) carried
across with ``interop.params_from_numpy``, the reduced gpt2-117m at 4
layers in fp32 under ``preln`` (the paper's analysed baseline) and ``fal``,
and the same tokens.

Tolerances (fp32 on both sides): CKA values 1e-5; the MHA-output gradient
magnitudes (sums of |g| over B x S x D entries) 1e-4 relative; each
ablation perplexity 1e-5 relative; the unrolled final state against the
port's ``forward`` 1e-4 (``tests/test_analysis_motivation.py``'s bound).
Plus the counterparts of ``tests/test_analysis_motivation.py:22-57`` and
``tests/test_fal_math.py:104-120`` (FAL's first-attention signal is the
same tensor at every depth)."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.core import analysis as RAN  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import analysis as TAN  # noqa: E402
from repro_torch.core import fal  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

from test_torch_tp import _weights  # noqa: E402

MODES = ("preln", "fal")
ARCH = "gpt2-117m"
CKA_TOL = 1e-5
GRAD_RTOL = 1e-4
PPL_RTOL = 1e-5
FINAL_TOL = 1e-4


def _cfgs(connection, arch=ARCH, n_layers=4):
    kw = dict(connection=connection, n_layers=n_layers)
    return (ref_config(arch).reduced().replace(**kw),
            get_config(arch).reduced().replace(**kw))


@functools.lru_cache(maxsize=None)
def _models(connection, arch=ARCH, n_layers=4):
    """(reference cfg, reference params, port cfg, port params, reference
    batch, port batch) on numpy weights and tokens."""
    rcfg, tcfg = _cfgs(connection, arch, n_layers)
    np_params = _weights(rcfg, 11)
    toks = np.random.default_rng(3).integers(
        0, rcfg.vocab, (2, 32)).astype(np.int32)
    rparams = jax.tree.map(jnp.asarray, np_params)
    tparams = interop.params_from_numpy(np_params, tcfg, "cpu",
                                        dtype="float32")
    return (rcfg, rparams, tcfg, tparams, {"tokens": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks)})


def _rel(got, want):
    return abs(got - want) / abs(want)


def test_linear_cka_matches_reference_identity_and_bounds():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    y = rng.standard_normal((64, 24)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert abs(float(TAN.linear_cka(tx, tx)) - 1.0) < 1e-5
    got = float(TAN.linear_cka(tx, ty))
    assert 0.0 <= got <= 1.0
    assert abs(got - float(RAN.linear_cka(jnp.asarray(x), jnp.asarray(y)))) \
        <= CKA_TOL


@pytest.mark.parametrize("mode", MODES)
def test_cka_table_matches_reference(mode):
    rcfg, rparams, tcfg, tparams, rb, tb = _models(mode)
    ops.reset_dispatch_paths()
    got = TAN.cka_table(tparams, tcfg, tb)
    want = RAN.cka_table(rparams, rcfg, rb)
    assert ops.dispatch_paths() == (
        {"flash_attention": ops.PLAIN, "fused_ln_add": ops.PLAIN}
        if mode == "fal" else {"flash_attention": ops.PLAIN})
    for k in ("mha_out", "mlp_in", "mlp_out"):
        assert len(got[k]) == tcfg.n_layers - 1
        assert all(0 <= v <= 1.0 + 1e-6 for v in got[k])
        np.testing.assert_allclose(got[k], want[k], atol=CKA_TOL, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_block_activations_match_reference_and_forward(mode):
    """Every captured (B, S, D) activation against the reference's, and the
    unrolled final state against the port's own ``forward``."""
    rcfg, rparams, tcfg, tparams, rb, tb = _models(mode)
    got = TAN.collect_block_activations(tparams, tcfg, tb)
    want = RAN.collect_block_activations(rparams, rcfg, rb)
    for k in ("mha_out", "mlp_in", "mlp_out", "x"):
        assert len(got[k]) == tcfg.n_layers
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=FINAL_TOL, rtol=0)
    with torch.no_grad():
        _, _, extras = TM.forward(tparams, tcfg, tb, want="hidden")
        logits = TM.forward(tparams, tcfg, tb)[0]
    assert float((got["final"] - extras["hidden"]).abs().max()) < FINAL_TOL
    assert float((TM.lm_head(tparams, tcfg, got["final"]) - logits)
                 .abs().max()) < FINAL_TOL


@pytest.mark.parametrize("mode", MODES)
def test_mha_gradient_magnitudes_match_reference(mode):
    rcfg, rparams, tcfg, tparams, rb, tb = _models(mode)
    got = TAN.mha_gradient_magnitudes(tparams, tcfg, tb)
    want = RAN.mha_gradient_magnitudes(rparams, rcfg, rb)
    assert len(got) == tcfg.n_layers
    assert all(m > 0 and np.isfinite(m) for m in got)
    for g, w in zip(got, want):
        assert _rel(g, w) <= GRAD_RTOL, (got, want)


ABLATIONS = {"base": {}, **{f"drop_layer={i}": dict(drop_layer=i)
                            for i in range(4)},
             "drop_connections": dict(drop_connections=True),
             "drop_all_mha": dict(drop_all_mha=True)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(ABLATIONS))
def test_ablation_perplexity_matches_reference(mode, case):
    rcfg, rparams, tcfg, tparams, rb, tb = _models(mode)
    kw = ABLATIONS[case]
    got = TAN.ablate_attention_perplexity(tparams, tcfg, tb, **kw)
    want = RAN.ablate_attention_perplexity(rparams, rcfg, rb, **kw)
    assert np.isfinite(got) and got > 1.0
    assert _rel(got, want) <= PPL_RTOL, (got, want)


def test_drop_connections_acts_only_under_preln():
    """Under fal the MHA -> MLP connections flag is a no-op (the reference
    removes ln2(x + a)'s attention only for preln); under preln it changes
    the perplexity."""
    for mode in MODES:
        _, _, tcfg, tparams, _, tb = _models(mode)
        base = TAN.ablate_attention_perplexity(tparams, tcfg, tb)
        cut = TAN.ablate_attention_perplexity(tparams, tcfg, tb,
                                              drop_connections=True)
        assert (cut == base) == (mode == "fal"), (mode, base, cut)


def test_fal_signal_constant_across_depth():
    """``tests/test_fal_math.py:104``: block 1's MLP input is ln2(x) plus
    the signal block 0 exported, at every position."""
    _, _, tcfg, tparams, _, tb = _models("fal", "llama3.2-3b", 2)
    rec = TAN.collect_block_activations(tparams, tcfg, tb)
    a1n = fal.first_attention_signal(tcfg, tparams["block0"],
                                     rec["mha_out"][0])
    pb = tparams["blocks"][0]
    recovered = rec["mlp_in"][1] - TL.norm_apply(pb["ln2"], rec["x"][1],
                                                 tcfg.norm)
    assert float((recovered - a1n).abs().max()) <= 1e-5
