"""ExecutionPlan: the typed description of how one program executes.

Port of ``repro/core/plan.py:59-327`` over ``torch.distributed``.  The
reference lays a program out on a ``jax.sharding.Mesh``; here a plan holds
a process group in its place (``ExecutionPlan.from_group``), whose ranks
are the tensor-parallel shards.  Plan axes:

* ``phase``  -- train | eval | prefill | decode | paged.
* ``tp``     -- none | gspmd | explicit.  ``explicit`` runs every family's
  blocks through the explicit partial-sum paths: the decoder (dense, MoE,
  VLM) through ``models/model.py::decoder_stack_tp``, whisper's encoder
  and decoder blocks, zamba2's shared block and mamba2 (whose mixers stay
  whole on every rank, no collective) in their own forwards.  Each rank
  holds its shard of the block weights (``launch/mesh.py::shard_params``)
  and the blocks pay the paper's per-block collectives (``core/tp.py``).
  ``gspmd`` has no PyTorch counterpart and raises.
* ``sequence_parallel`` -- Megatron-SP LN regions under explicit TP: the
  residual stream between blocks is sharded along the sequence and every
  per-block all-reduce becomes a reduce-scatter behind an all-gather.
* ``dual_branch`` -- decode-time MHA || MLP branch parallelism.
* ``grad_compress`` -- none | int8 | lowrank: the backward TP collectives
  of the explicit stack run ``optim/grad_compress.py``'s lossy exchanges
  (forward collectives stay exact); requires ``tp='explicit'``.
* ``data_group`` -- the data-parallel process group (the counterpart of
  the reference's ``data_axes``): each of its ranks trains on its rows of
  the global batch and the train step sums the gradients over it
  (``train/step.py``).  ``tp='none'`` with a data group is pure data
  parallelism.  ``core.tp.init_groups`` builds both groups from one world,
  TP the inner axis (``rank = dp_rank * tp + tp_rank``).
* ``fsdp`` -- ZeRO-3 over the data group, the reference's default layout
  (its ``fsdp_axes``): each data rank holds a slice of every FSDP leaf
  (``launch/mesh.py::fsdp_specs``) and of its AdamW moments, gathers a
  unit's leaves when the unit runs and reduce-scatters their gradients
  (``core.tp.gather_fsdp``).  Requires a data group: the rank's state
  layout must be known to the step, where the reference carries it in
  shardings.
* ``seq_axes`` -- the contiguous decode tick's cache layout (reference
  ``launch/mesh.py::cache_specs``, port ``launch/mesh.py``): the axes,
  ``"data"`` and / or ``"model"``, over which the KV sequence (MLA: the
  latent's) is cut, set by ``with_cache_layout(cfg, batch)``.  Each rank
  then holds the positions [lo, hi) of its part, writes a new row only
  where it falls in them, and the attention combines the ranks' partial
  softmaxes over those groups (``models/attention.py::seq_combine``).
  Over ``data`` every data rank serves the same rows in lockstep, like
  TP ranks; over ``model`` every rank attends all heads over its
  positions.  None until a decode plan is pinned (``serving_plan`` then
  takes the layout of a batch that divides the data ranks).

Inside the stack the blocks see ``plan.inner()``, on which ``tp_axis`` is
the process group the partial sums reduce over (None on replicated paths).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any


class Phase(enum.Enum):
    """Execution phase."""
    TRAIN = "train"
    EVAL = "eval"
    PREFILL = "prefill"
    DECODE = "decode"
    PAGED = "paged"

    @classmethod
    def coerce(cls, v) -> "Phase":
        if isinstance(v, Phase):
            return v
        try:
            return cls(v)
        except ValueError:
            raise ValueError(
                f"unknown phase {v!r}; valid: "
                f"{[p.value for p in cls]}") from None


#: phases that run the full-sequence block path (vs KV-cache decode/paged)
FULL_SEQUENCE_PHASES = (Phase.TRAIN, Phase.EVAL, Phase.PREFILL)


class TPStyle(enum.Enum):
    """Tensor-parallel style."""
    NONE = "none"
    GSPMD = "gspmd"
    EXPLICIT = "explicit"

    @classmethod
    def coerce(cls, v) -> "TPStyle":
        if isinstance(v, TPStyle):
            return v
        if v is None:
            return cls.NONE
        try:
            return cls(v)
        except ValueError:
            raise ValueError(
                f"unknown TP style {v!r}; valid: "
                f"{[t.value for t in cls]}") from None


#: families with an explicit partial-sum TP stack in the port: the decoder
#: families, and mamba2 (mixers replicated), zamba2 (its shared block
#: sharded) and whisper (encoder and decoder blocks sharded), the layouts
#: of the reference's ``param_specs``
EXPLICIT_TP_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")

#: families with forwards of their own (not the decoder's stack): they have
#: no sequence-parallel layout (mamba layers have none; cross-attention and
#: bidirectional encoders consume the assembled attention, reference
#: ``models/blocks.py:131-139``) and shard only under ``tp='explicit'``
OWN_FORWARD_FAMILIES = ("ssm", "hybrid", "audio")

#: families whose decode path runs FAL transformer blocks
DUAL_BRANCH_FAMILIES = ("dense", "moe", "vlm", "hybrid")

_LATER = "(ROADMAP.md Queue 1)"


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Frozen description of how one program executes.  ``group`` is the
    tensor-parallel process group (None: no TP), ``data_group`` the
    data-parallel one (None: no DP); ``local`` is set only on the plan the
    blocks inside the stack see (``inner()``)."""
    phase: Phase = Phase.TRAIN
    tp: TPStyle = TPStyle.NONE
    sequence_parallel: bool = False
    dual_branch: bool = False
    grad_compress: str = "none"            # none | int8 | lowrank
    group: Any = None                      # torch.distributed ProcessGroup
    data_group: Any = None                 # the data-parallel group
    fsdp: bool = False                     # params sliced over data_group
    seq_axes: Any = None                   # the decode cache's cut axes
    local: bool = False                    # set only by inner()

    # ------------------------------------------------------------- build --
    @classmethod
    def single_device(cls, phase=Phase.TRAIN,
                      dual_branch: bool = False) -> "ExecutionPlan":
        """Replicated single-program plan (no group, no TP)."""
        return cls(phase=Phase.coerce(phase), dual_branch=bool(dual_branch))

    @classmethod
    def from_group(cls, group, *, tp="explicit", sp: bool = False,
                   phase=Phase.TRAIN, dual_branch: bool = False,
                   grad_compress: str = "none",
                   data_group=None, fsdp: bool = False) -> "ExecutionPlan":
        """Plan over the tensor-parallel process ``group`` and the
        data-parallel ``data_group`` (the counterpart of the reference's
        ``from_mesh`` over ``("data", "model")``); either may be None.
        ``fsdp``: the params are FSDP slices over ``data_group``."""
        return cls(phase=Phase.coerce(phase), tp=TPStyle.coerce(tp),
                   sequence_parallel=bool(sp), group=group,
                   data_group=data_group, dual_branch=bool(dual_branch),
                   grad_compress=str(grad_compress), fsdp=bool(fsdp))

    @classmethod
    def resolve(cls, plan) -> "ExecutionPlan":
        """Accepts an ExecutionPlan, a Phase (or its string value), or None
        (single device, train); context dicts are rejected."""
        if isinstance(plan, ExecutionPlan):
            return plan
        if isinstance(plan, dict):
            raise TypeError(
                "context dicts are no longer accepted (the one-release "
                "shim expired); construct an ExecutionPlan (core.plan) — "
                "e.g. ExecutionPlan.from_group(group, tp='explicit')")
        phase = Phase.coerce(plan) if plan is not None else Phase.TRAIN
        return cls.single_device(phase)

    # -------------------------------------------------------- derived -----
    def with_phase(self, phase) -> "ExecutionPlan":
        return dataclasses.replace(self, phase=Phase.coerce(phase))

    def with_dual_branch(self, flag: bool = True) -> "ExecutionPlan":
        """Same plan with MHA||MLP decode branch parallelism toggled."""
        return dataclasses.replace(self, dual_branch=bool(flag))

    def with_grad_compress(self, method: str) -> "ExecutionPlan":
        """Same plan with compressed backward TP collectives selected."""
        return dataclasses.replace(self, grad_compress=str(method))

    def with_cache_layout(self, cfg, batch=None) -> "ExecutionPlan":
        """Same plan with the decode cache's layout of ``cfg`` at this
        plan's TP and data sizes and the global ``batch`` (None: a batch
        that divides the data ranks, each serving its own rows):
        ``seq_axes`` from ``launch/mesh.py::seq_axes``."""
        from repro_torch.launch import mesh as MX
        b = self.dp_size if batch is None else batch
        return dataclasses.replace(self, seq_axes=MX.seq_axes(
            cfg, self.tp_size, self.dp_size, b))

    def inner(self) -> "ExecutionPlan":
        """The plan the blocks inside the explicit-TP stack see:
        ``tp_axis`` set, ``use_explicit_tp`` off."""
        return dataclasses.replace(self, local=True)

    @property
    def tp_size(self) -> int:
        return 1 if self.group is None else self.group.size()

    @property
    def tp_rank(self) -> int:
        return 0 if self.group is None else self.group.rank()

    @property
    def dp_size(self) -> int:
        return 1 if self.data_group is None else self.data_group.size()

    @property
    def dp_rank(self) -> int:
        return 0 if self.data_group is None else self.data_group.rank()

    @property
    def seq_groups(self) -> tuple:
        """The process groups that cut the decode cache's sequence, in
        the order the softmax combines over them: model (inner), then
        data."""
        axes = self.seq_axes or ()
        return tuple(g for a, g in (("model", self.group),
                                    ("data", self.data_group))
                     if a in axes)

    @property
    def seq_part(self) -> tuple:
        """(index, count): this rank's part of the decode cache's
        sequence, data outer and model inner."""
        from repro_torch.launch import mesh as MX
        return MX.axes_part(self.seq_axes or (), self.tp_rank, self.dp_rank,
                            self.tp_size, self.dp_size)

    @property
    def tp_axis(self):
        """The process group the blocks' partial sums reduce over: set only
        on ``inner()``; None on replicated paths."""
        return self.group if self.local else None

    @property
    def use_explicit_tp(self) -> bool:
        """True when the caller asked for the explicit partial-sum stack."""
        return (self.tp is TPStyle.EXPLICIT and self.group is not None
                and not self.local)

    @property
    def is_sharded(self) -> bool:
        """Whether the weights are sharded (TP); a data group replicates
        them."""
        return self.group is not None

    @property
    def full_sequence(self) -> bool:
        return self.phase in FULL_SEQUENCE_PHASES

    # -------------------------------------------------------- validate ----
    def validate(self, cfg) -> "ExecutionPlan":
        """Fail loudly when the plan cannot execute ``cfg``; returns self."""
        if self.tp is TPStyle.GSPMD:
            raise NotImplementedError(
                f"tp='gspmd' lets XLA shard against PartitionSpecs; it has "
                f"no PyTorch counterpart: use tp='explicit' {_LATER}")
        if self.sequence_parallel and self.tp is not TPStyle.EXPLICIT:
            raise ValueError(
                "sequence_parallel=True requires tp='explicit': SP shards "
                "inter-block activations inside the explicit partial-sum "
                "stack; there is no replicated SP path")
        if self.sequence_parallel and self.phase not in FULL_SEQUENCE_PHASES:
            raise ValueError(
                f"sequence_parallel=True is a full-sequence layout "
                f"(train/eval/prefill); phase={self.phase.value} decodes "
                f"single tokens against KV caches")
        if self.dual_branch:
            self._validate_dual_branch(cfg)
        if self.grad_compress not in ("none", "int8", "lowrank"):
            raise ValueError(
                f"unknown grad_compress {self.grad_compress!r}; valid: "
                f"none/int8/lowrank (optim/grad_compress.py methods)")
        if self.grad_compress != "none" and self.tp is not TPStyle.EXPLICIT:
            raise ValueError(
                "grad_compress != 'none' requires tp='explicit': the "
                "compressed collectives wrap the explicit-TP partial-sum "
                "collectives (models/blocks.py); there is no replicated "
                "gradient-compression path")
        if self.fsdp and self.data_group is None:
            raise ValueError(
                "fsdp=True requires a data group: the params are sliced "
                "over it (launch/mesh.py::shard_fsdp)")
        for axis in self.seq_axes or ():
            if (self.group if axis == "model" else self.data_group) is None:
                raise ValueError(
                    f"seq_axes={self.seq_axes}: the KV sequence is cut over "
                    f"'{axis}' but the plan has no such group")
        if self.sequence_parallel and cfg.family in OWN_FORWARD_FAMILIES:
            raise NotImplementedError(
                f"sequence_parallel=True: family '{cfg.family}' has no "
                f"sequence-parallel layout (mamba layers have none; "
                f"cross-attention and bidirectional encoders consume the "
                f"assembled attention)")
        if self.group is not None and self.tp is not TPStyle.EXPLICIT \
                and cfg.family in OWN_FORWARD_FAMILIES:
            raise ValueError(
                f"family '{cfg.family}' over a process group needs "
                f"tp='explicit' (got tp='{self.tp.value}'): its blocks shard "
                f"only through the explicit partial-sum paths")
        if self.tp is TPStyle.EXPLICIT:
            if self.group is None:
                raise ValueError("tp='explicit' requires a process group "
                                 "(the explicit-TP stack shards over it)")
            if cfg.family not in EXPLICIT_TP_FAMILIES:
                raise ValueError(
                    f"tp='explicit': family '{cfg.family}' has no "
                    f"explicit-TP stack ({EXPLICIT_TP_FAMILIES}) — running "
                    f"it would silently fall back and mislabel any numbers")
            if cfg.family == "hybrid" and cfg.connection == "ablation2":
                raise NotImplementedError(
                    "tp='explicit': zamba2's shared block under ablation2 "
                    "assembles its attention at invocation 0 (preln) and "
                    "fuses it later, so its ln1 / ln2 gradients would be "
                    "whole at one invocation and partial at the others; "
                    "one sum over the group cannot join them")
            self._check_divisibility(cfg)
        return self

    def _validate_dual_branch(self, cfg):
        from repro_torch.core import fal
        if self.phase not in (Phase.DECODE, Phase.PAGED):
            raise ValueError(
                f"dual_branch=True is a decode-time dispatch (decode/paged "
                f"phases); phase={self.phase.value} runs full-sequence "
                f"blocks whose collective structure is fixed by the "
                f"connection mode, not by branch scheduling")
        if cfg.family not in DUAL_BRANCH_FAMILIES:
            raise ValueError(
                f"dual_branch=True: family '{cfg.family}' has no MHA||MLP "
                f"decode dispatch ({DUAL_BRANCH_FAMILIES} only) — audio "
                f"decoder blocks consume cross-attention and ssm blocks "
                f"have no attention/MLP fork; running it would silently "
                f"fall back and mislabel any numbers")
        if cfg.connection not in fal.DUAL_BRANCH_MODES:
            raise ValueError(
                f"dual_branch=True requires a connection whose MLP input "
                f"is independent of the block's own attention "
                f"({'/'.join(fal.DUAL_BRANCH_MODES)}); "
                f"'{cfg.connection}' must assemble MHA output before the "
                f"MLP can start, so the branches cannot run concurrently")
        if cfg.post_norms:
            raise ValueError(
                "dual_branch=True: post_norms normalise the assembled "
                "attention output before the residual merge — the MLP "
                "branch cannot be issued concurrently with the KV gather")

    def _check_divisibility(self, cfg):
        """Explicit TP shards heads, the FFN hidden and the experts
        evenly: fail loudly when the config does not divide.  An
        attention-free config (mamba2: its mixers stay whole) divides every
        group."""
        tp_size = self.tp_size
        if cfg.family == "ssm" or not cfg.n_heads:
            return

        def div(n, what):
            if n % tp_size:
                raise ValueError(f"explicit TP: {what}={n} is not divisible "
                                 f"by tp_size={tp_size}")
        div(cfg.n_heads, "n_heads")
        # MLA has no KV heads to shard: its latent is replicated and the
        # up-projections split by query heads (reference plan.py:316)
        if not cfg.use_mla and cfg.n_kv_heads % tp_size \
                and tp_size % cfg.n_kv_heads:
            # n_kv_heads < tp_size is fine when groups align (KV
            # replication, attention._kv_group_slice); anything else cannot
            # shard evenly
            raise ValueError(f"explicit TP: n_kv_heads={cfg.n_kv_heads} "
                             f"divides neither way with tp_size={tp_size}")
        div(cfg.dense_d_ff or cfg.d_ff, "d_ff")
        if cfg.n_experts:
            div(cfg.n_experts, "n_experts")
            if cfg.n_shared_experts:
                div(cfg.moe_d_ff * cfg.n_shared_experts, "shared-expert d_ff")


def local_kv_heads(cfg, tp_size: int) -> int:
    """KV heads a rank's paged pools hold: ``n_kv_heads / tp``, or 1 when
    the KV heads are replicated (``n_kv_heads < tp``).  The contiguous
    decode cache follows the reference's layout instead
    (``launch/mesh.py::cache_specs``: every KV head over a part of the
    sequence when they do not divide the ranks)."""
    return cfg.n_kv_heads // tp_size if cfg.n_kv_heads % tp_size == 0 else 1


def kv_replicated(cfg, tp_size: int) -> bool:
    """Megatron's GQA fallback: ``wk`` / ``wv`` whole on every rank when
    the KV heads do not divide over the ranks.  Never under MLA, which has
    no ``wk`` / ``wv``."""
    return not cfg.use_mla and cfg.n_kv_heads % tp_size != 0

