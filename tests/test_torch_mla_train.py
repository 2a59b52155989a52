"""The port's deepseek-v3 decoder against the JAX package's, on the CPU in
fp32 at the reduced deepseek-v3-671b (as ``test_torch_mla_model.py``),
weights carried across with ``interop.params_from_numpy``: the family
gates, the parameter tree (the ``mtp`` subtree included) and training.

* ``check_supported`` takes MLA and the VLM family, and still refuses
  SSM, hybrid and audio;
* the tree of ``init_params`` is the reference's;
* in all six connection modes: forward logits, ``loss_fn`` (ce, aux and
  mtp) and ``jax.grad`` of the loss on every leaf, the MTP head's
  included; with remat, the same loss and gradients bit for bit.

Tolerances: logits and losses 1e-5, gradients 1e-6 plus 1e-4 of the
leaf's largest value (``test_torch_tp.py``'s)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.models import model as RM  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402

import test_torch_mla_model as TMM  # noqa: E402
import test_torch_tp as TTP  # noqa: E402
import torch_tp_ranks as R  # noqa: E402
from test_torch_train import _close_tree  # noqa: E402

ARCH, TOL = TMM.ARCH, TMM.TOL
_cfgs, _close = TMM._cfgs, TMM._close


# --------------------------------------------------------------------------- #
# the gates and the parameter tree
# --------------------------------------------------------------------------- #
def test_mla_and_vlm_are_accepted_and_the_rest_still_raise():
    TM.check_supported(get_config(ARCH))
    TM.check_supported(get_config("llava-next-mistral-7b"))
    for arch in ("mamba2-370m", "zamba2-1.2b", "whisper-small"):
        with pytest.raises(NotImplementedError, match="item 4"):
            TM.check_supported(get_config(arch))


def test_init_params_matches_the_reference_tree():
    rcfg, tcfg = _cfgs(n_layers=3)
    shapes = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                            jax.random.PRNGKey(0))
    tparams = TM.init_params(tcfg, device="cpu")
    assert set(tparams["mtp"]) == {"proj", "norm_h", "norm_e", "block"}
    assert "ln_fal" not in tparams["mtp"]["block"]           # preln block
    assert set(tparams["block0"]["attn"]) == {
        "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk",
        "w_uv", "wo"}
    ref = interop.params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), tcfg,
        "cpu")
    got, want = dict(TO.named_leaves(tparams)), dict(TO.named_leaves(ref))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k


# --------------------------------------------------------------------------- #
# forward, loss and gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", R.MODES)
def test_forward_loss_and_gradients_match_reference(mode):
    rcfg, tcfg = _cfgs(connection=mode)
    params = TTP._weights(rcfg, 11)
    toks = np.random.default_rng(2).integers(0, rcfg.vocab, (2, 20)) \
        .astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}

    def run(p):
        (value, metrics), grads = jax.value_and_grad(
            lambda q: RM.loss_fn(q, rcfg, batch), has_aux=True)(p)
        return RM.forward(p, rcfg, batch)[0], value, metrics, grads
    r_logits, r_loss, r_m, r_grads = jax.jit(run)(params)
    assert set(r_m) == {"ce", "aux", "mtp"}
    tparams = interop.params_from_numpy(params, tcfg, "cpu",
                                        dtype="float32")
    for _, t in TO.named_leaves(tparams):
        t.requires_grad_(True)
    tb = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        logits = TM.forward(tparams, tcfg, tb)[0]
    loss, m = TM.loss_fn(tparams, tcfg, tb)
    loss.backward()
    _close(r_logits, logits, TOL)
    assert abs(float(loss.detach()) - float(r_loss)) <= TOL
    assert set(m) == {"ce", "aux", "mtp"}
    for k in m:
        assert abs(float(m[k].detach()) - float(r_m[k])) <= TOL, k
    _close_tree(jax.tree.map(np.asarray, r_grads),
                TO.map_tree(lambda t: t.grad, tparams), tcfg, 1e-6, 1e-4)


def test_remat_gives_the_same_loss_and_gradients():
    """Under ``cfg.remat`` the blocks, the CE tail and the MTP loss run
    under checkpointing: the same loss and gradients, bit for bit."""
    _, tcfg = _cfgs()
    out = []
    for remat in (False, True):
        cfg = tcfg.replace(remat=remat)
        params = TM.init_params(cfg, seed=3, device="cpu")
        for _, t in TO.named_leaves(params):
            t.requires_grad_(True)
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab, (2, 16)))
        loss, m = TM.loss_fn(params, cfg, {"tokens": toks})
        loss.backward()
        out.append((loss.detach(), float(m["mtp"].detach()),
                    [t.grad for _, t in TO.named_leaves(params)]))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)
