"""The port's hybrid family (zamba2-1.2b, reduced) against the JAX package,
on the CPU in fp32, weights carried across with ``interop.params_from_numpy``:
a mamba2 backbone in groups of ``attn_every`` layers, each group followed
by one invocation of the weight-shared FAL attention block through its
group's ``in_proj``, then the trailing mamba layers.

* forward logits, ``loss_fn`` and every gradient leaf (the shared block's
  weights collect gradients from every invocation, ``in_proj`` per group),
  in fal, falplus (the injected ``shared_ln_fal``) and preln, with 2
  groups and a trailing layer (5 layers) and with 2 groups and none;
* 20 ``decode_step`` ticks against the reference's, logits and every cache
  leaf (the groups' ``state`` / ``conv``, the shared block's K / V a
  group, the tail), sequential and under ``dual_branch``;
* dual-branch decode bit-identical to sequential
  (``tests/test_dual_branch.py:186`` holds the reference to the same);
* ``init_params``' tree, and the paged entry points' refusal.

Bounds as ``test_torch_ssm.py``'s: 1e-5 of max(1, the largest value) for
logits, losses and caches, gradients 1e-6 plus 1e-4 of the leaf's largest
value; dual against sequential bit for bit."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.core.plan import ExecutionPlan as RPlan  # noqa: E402
from repro.core.plan import Phase as RPhase  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.plan import ExecutionPlan as TPlan  # noqa: E402
from repro_torch.core.plan import Phase as TPhase  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

import test_torch_ssm as T  # noqa: E402

ARCH = "zamba2-1.2b"


def _dual(dual):
    return (RPlan.single_device(RPhase.DECODE, dual_branch=dual),
            TPlan.single_device(TPhase.DECODE, dual_branch=dual))


@pytest.mark.parametrize("connection,n_layers", [
    ("fal", 5), ("falplus", 5), ("preln", 4)])
def test_forward_loss_and_gradients_match_reference(connection, n_layers):
    T.family_forward_loss_and_grads(ARCH, connection=connection,
                                    n_layers=n_layers)


def test_tree_counts_groups_and_tail():
    _, rparams, tcfg, tparams = T.models(ARCH, n_layers=5)
    assert TM._zamba_counts(tcfg) == (2, 1)
    assert [len(g) for g in tparams["mamba"]] == [2, 2]
    assert len(tparams["mamba_tail"]) == 1
    assert tparams["in_proj"].shape == (2, 2 * tcfg.d_model, tcfg.d_model)
    assert "ln_a" in tparams["shared"] and "ln_fal" not in tparams["shared"]
    T.init_tree_matches(ARCH)


@pytest.mark.parametrize("dual", [False, True])
def test_decode_step_matches_reference(dual):
    T.decode_matches_reference(ARCH, plan=_dual(dual), n_layers=5)


def test_dual_branch_decode_bit_identical_to_sequential():
    """Under ``dual_branch`` the invocations after the first run the MHA ||
    MLP block (``_block_apply_dual``'s contiguous route: op for op the
    sequential path's), so the logits and caches are the same bits."""
    _, _, tcfg, tparams = T.models(ARCH, n_layers=5)
    toks = T._tokens(tcfg, 2, 12, seed=5)
    runs = []
    for dual in (False, True):
        cache = TM.init_cache(tcfg, 2, 12, "float32", device="cpu")
        plan = _dual(dual)[1]
        outs = []
        with torch.no_grad():
            for t in range(12):
                lg, cache = TM.decode_step(
                    tparams, tcfg,
                    {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                     "pos": torch.full((2,), t, dtype=torch.int32)},
                    cache, plan)
                outs.append(lg)
        runs.append((torch.cat(outs, 1), cache))
    assert torch.equal(runs[0][0], runs[1][0])
    for k in runs[0][1]:
        for name, v in runs[0][1][k].items():
            assert torch.equal(v, runs[1][1][k][name]), (k, name)


def test_decode_launches_ln_add_per_invocation():
    """fal's MLP input is one ``ops.fused_ln_add`` per shared-block
    invocation (block 0's ln2(x) + ln_a(a) included); the mamba layers
    run none."""
    _, _, tcfg, tparams = T.models(ARCH, n_layers=5)
    cache = TM.init_cache(tcfg, 1, 4, "float32", device="cpu")
    ops.reset_dispatch_paths()
    with torch.no_grad():
        TM.decode_step(tparams, tcfg,
                       {"tokens": torch.zeros((1, 1), dtype=torch.int32),
                        "pos": torch.zeros((1,), dtype=torch.int32)}, cache)
    assert ops.dispatch_paths() == {"fused_ln_add": ops.PLAIN}


def test_paged_entry_points_refuse_like_reference():
    T.paged_refusals_match(ARCH)
    assert get_config(ARCH).family not in TM.PAGED_FAMILIES
