"""The port's audio family (whisper-small, reduced: 2 + 2 layers, 16
frames) against the JAX package, on the CPU in fp32, weights carried across
with ``interop.params_from_numpy``, frames drawn with numpy:

* ``attention.gqa_cross_apply`` at Sq != Sk, and a decoder block with
  cross-attention (``block_apply(enc_out=)``) against the reference's;
* ``whisper_encode`` (bidirectional, ``enc_pos``, its own block-0
  signal), forward logits, ``loss_fn`` and every gradient leaf (the
  encoder's through the cross-attention), in fal and preln;
* 20 ``decode_step`` ticks with ``cache["enc_out"]`` filled by
  ``whisper_encode``, logits and every cache leaf;
* dual-branch refused for audio and ssm, as the reference refuses it (at
  ``plan.validate``, and a cross-attention block under a dual plan);
* ``init_params``' tree, and the paged entry points' refusal.

Bounds as ``test_torch_ssm.py``'s: 1e-5 of max(1, the largest value) for
outputs, logits, losses and caches; gradients 1e-6 plus 1e-4 of the
leaf's largest value."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.core.plan import ExecutionPlan as RPlan  # noqa: E402
from repro.core.plan import Phase as RPhase  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import blocks as RB  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.plan import ExecutionPlan as TPlan  # noqa: E402
from repro_torch.core.plan import Phase as TPhase  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

import test_torch_ssm as T  # noqa: E402

ARCH = "whisper-small"


def _frames(cfg, B=2, seed=9):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.n_enc_frames, cfg.d_model)) \
        .astype(np.float32)


def _batch(cfg):
    return {"tokens": T._tokens(cfg, 2, 24), "frames": _frames(cfg)}


def test_cross_attention_matches_reference_at_sq_ne_sk():
    rcfg, rparams, tcfg, tparams = T.models(ARCH)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    enc = _frames(tcfg, seed=2)
    rp = jax.tree.map(lambda a: a[0], rparams["dec_blocks"]["xattn"])
    ops.reset_dispatch_paths()
    got = TA.gqa_cross_apply(tparams["dec_blocks"][0]["xattn"], tcfg,
                             torch.from_numpy(x), torch.from_numpy(enc))
    want = RA.gqa_cross_apply(rp, rcfg, jnp.asarray(x), jnp.asarray(enc))
    assert got.shape == (2, 7, tcfg.d_model)
    T._close(got, want)
    assert ops.dispatch_paths() == {"flash_attention": ops.PLAIN}


def test_cross_block_matches_reference():
    """A decoder block: self-attention, then cross-attention after the
    residual (the FAL MLP input sees it, not the block's own attention)."""
    rcfg, rparams, tcfg, tparams = T.models(ARCH)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    sig = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    enc = _frames(tcfg, seed=4)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    rp = jax.tree.map(lambda a: a[0], rparams["dec_blocks"])
    want, r_a, _, _ = RB.block_apply(rp, rcfg, jnp.asarray(x),
                                     jnp.asarray(sig), jnp.asarray(pos), 0,
                                     enc_out=jnp.asarray(enc))
    with torch.no_grad():
        got, t_a, _ = TB.block_apply(
            tparams["dec_blocks"][0], tcfg, torch.from_numpy(x),
            torch.from_numpy(sig), positions=torch.from_numpy(pos.copy()),
            enc_out=torch.from_numpy(enc))
    T._close(got, want)
    T._close(t_a, r_a)


def test_encoder_matches_reference():
    rcfg, rparams, tcfg, tparams = T.models(ARCH)
    fr = _frames(tcfg)
    with torch.no_grad():
        got = TM.whisper_encode(tparams, tcfg, torch.from_numpy(fr))
    T._close(got, RM.whisper_encode(rparams, rcfg, jnp.asarray(fr)))


@pytest.mark.parametrize("connection", ["fal", "preln"])
def test_forward_loss_and_gradients_match_reference(connection):
    T.family_forward_loss_and_grads(ARCH, _batch, connection=connection)


def test_decode_with_enc_out_matches_reference():
    def prepare(rcfg, rparams, tcfg, tparams, rc, tc):
        fr = _frames(tcfg)
        rc = dict(rc, enc_out=RM.whisper_encode(rparams, rcfg,
                                                jnp.asarray(fr)))
        with torch.no_grad():
            tc["enc_out"].copy_(TM.whisper_encode(tparams, tcfg,
                                                  torch.from_numpy(fr)))
        return rc

    T.decode_matches_reference(ARCH, prepare=prepare)


@pytest.mark.parametrize("arch", [ARCH, "mamba2-370m"])
def test_dual_branch_refused_like_reference(arch):
    rplan = RPlan.single_device(RPhase.DECODE, dual_branch=True)
    tplan = TPlan.single_device(TPhase.DECODE, dual_branch=True)
    with pytest.raises(ValueError) as r_err:
        rplan.validate(ref_config(arch).reduced())
    with pytest.raises(ValueError) as t_err:
        tplan.validate(get_config(arch).reduced())
    assert "has no MHA||MLP decode dispatch" in str(t_err.value)
    assert str(t_err.value) == str(r_err.value)
    if arch == ARCH:
        # a cross-attention block handed a dual plan directly
        _, _, tcfg, tparams = T.models(ARCH)
        with pytest.raises(NotImplementedError, match="cross-attention"):
            TB.block_apply(tparams["dec_blocks"][0], tcfg,
                           torch.zeros((1, 1, tcfg.d_model)), None,
                           plan=tplan)


def test_init_tree_and_paged_refusals():
    T.init_tree_matches(ARCH)
    T.paged_refusals_match(ARCH)
