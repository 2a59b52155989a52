"""FAL (First Attentions Last): the connection modes, on torch tensors.

Port of ``repro/core/fal.py``.  A transformer block is
``x + MHA(ln1(x)) + MLP(mlp_input)``; the paper's technique is the choice
of ``mlp_input``:

  preln     : ln2(x + a)                      -- baseline (eq 1)
  parallel  : ln2(x)                          -- PaLM/GPT-J baseline
  fal       : ln2(x) + ln_a(a1)               -- eq (2); a1 = first block's MHA
                                                 output, ln_a owned by block 1
  falplus   : ln2(x + a) + ln_fal_i(a1)       -- eq (7)
  ablation1 : ln2(x) + ln_fal_i(a)            -- Apdx D.1
  ablation2 : block0 preln, later blocks MLP(ln2(x))  -- Apdx D.1

Every ``norm(u) + v`` sum goes through ``kernels.ops.fused_ln_add`` (the
fused LN-add kernel on the card, ``ref.ln_add_ref``'s plain version on the
CPU): fal's ``ln2(x) + a1_sig`` in every block, falplus's
``ln_fal(a1) + ln2(x + a)``, ablation1's ``ln2(x) + ln_fal(a)`` and block
1's ``ln2(x) + ln_a(a)`` under fal.  In fp32 that is the reference's bits;
in bf16 the sum is rounded once where the reference rounds twice, at most
one bf16 ulp of the larger of |LN(u)| and the sum apart
(``kernels/fused_ln_add.py``).
"""
from __future__ import annotations

from repro_torch.kernels import ops
from repro_torch.models import layers as L

_NEEDS_LOCAL_ATTN = {"preln": True, "parallel": False, "fal": False,
                     "falplus": True, "ablation1": True, "ablation2": False}

#: modes with a per-block LN over the injected signal
NEEDS_LN_FAL = {"falplus", "ablation1"}
#: modes that consume the first block's attention output
USES_FIRST_ATTENTION = {"fal", "falplus"}
#: modes whose MLP input runs ``ops.fused_ln_add``: every block under fal
#: and ablation1, every block but block 0 under falplus
FUSED_LN_ADD_MODES = ("fal", "falplus", "ablation1")
#: modes whose steady-state MLP input is independent of the block's own
#: attention output (the decode-time MHA||MLP dual-branch property)
DUAL_BRANCH_MODES = tuple(m for m, dep in _NEEDS_LOCAL_ATTN.items()
                          if not dep)


def mlp_input_depends_on_local_attention(mode: str) -> bool:
    return _NEEDS_LOCAL_ATTN[mode]


def attention_must_assemble(mode: str, is_block0: bool = False) -> bool:
    """True when the block's own MHA output must be fully assembled before
    its MLP input / signal export can be formed (block 0 assembles for
    every mode but ``parallel``)."""
    if is_block0:
        return mode != "parallel"
    return _NEEDS_LOCAL_ATTN[mode]


def first_attention_signal(cfg, block0_params, a1_raw):
    """What block 1 exports to the rest of the depth: FAL normalises once
    (``ln_a``), FAL+ exports the raw tensor, other modes export nothing."""
    if cfg.connection == "fal":
        return L.norm_apply(block0_params["ln_a"], a1_raw, cfg.norm)
    if cfg.connection == "falplus":
        return a1_raw
    return None


def _ln_add(p, u, v, kind):
    """``norm_apply(p, u, kind) + v`` in one fused pass."""
    return ops.fused_ln_add(u, v, p["scale"], p.get("bias"), kind=kind)


def mlp_input(cfg, p, x, a, a1_sig, norm_kind=None):
    """The MLP input of one block for ``cfg.connection``.  x: the block
    input; a: this block's MHA output; a1_sig: ``first_attention_signal``
    (None unless fal/falplus)."""
    nk = norm_kind or cfg.norm
    mode = cfg.connection
    if mode == "preln":
        return L.norm_apply(p["ln2"], x + a, nk)
    if mode == "parallel" or mode == "ablation2":
        return L.norm_apply(p["ln2"], x, nk)
    if mode == "fal":
        return _ln_add(p["ln2"], x, a1_sig.to(x.dtype), nk)
    if mode == "falplus":
        return _ln_add(p["ln_fal"], a1_sig.to(x.dtype),
                       L.norm_apply(p["ln2"], x + a, nk), nk)
    if mode == "ablation1":
        return _ln_add(p["ln2"], x, L.norm_apply(p["ln_fal"], a, nk), nk)
    raise ValueError(mode)


def block0_mlp_input(cfg, p, x, a, norm_kind=None):
    """Block 1's MLP input: FAL feeds ``ln2(x) + ln_a(a)`` (eq 2, i=1);
    ablation2 and falplus keep the direct connection; the other modes
    behave as in later blocks."""
    nk = norm_kind or cfg.norm
    mode = cfg.connection
    if mode == "fal":
        return _ln_add(p["ln2"], x, L.norm_apply(p["ln_a"], a, nk), nk)
    if mode == "ablation2":
        return L.norm_apply(p["ln2"], x + a, nk)
    if mode == "falplus":
        return L.norm_apply(p["ln2"], x + a, nk)
    return mlp_input(cfg, p, x, a, None, nk) if mode in ("preln", "parallel") \
        else mlp_input(cfg, p, x, a, a, nk)
