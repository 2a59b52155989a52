"""ExecutionPlan: the typed description of how one program executes.

Port of ``repro/core/plan.py`` for one device: the phase and the
dual-branch flag, with the reference's validation messages.  There is no
mesh, no tensor or sequence parallelism and no gradient compression yet;
those come with the port's distributed slice.
"""
from __future__ import annotations

import dataclasses
import enum


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

#: families whose decode path runs FAL transformer blocks
DUAL_BRANCH_FAMILIES = ("dense", "moe", "vlm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Frozen single-device plan: ``phase`` and ``dual_branch``."""
    phase: Phase = Phase.TRAIN
    dual_branch: bool = False

    @classmethod
    def single_device(cls, phase=Phase.TRAIN,
                      dual_branch: bool = False) -> "ExecutionPlan":
        """Replicated single-program plan (no mesh, no TP)."""
        return cls(phase=Phase.coerce(phase), dual_branch=bool(dual_branch))

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
                "e.g. ExecutionPlan.from_mesh(mesh, tp='explicit')")
        phase = Phase.coerce(plan) if plan is not None else Phase.TRAIN
        return cls.single_device(phase)

    def with_phase(self, phase) -> "ExecutionPlan":
        return dataclasses.replace(self, phase=Phase.coerce(phase))

    def with_dual_branch(self, flag: bool = True) -> "ExecutionPlan":
        """Same plan with MHA||MLP decode branch parallelism toggled."""
        return dataclasses.replace(self, dual_branch=bool(flag))

    @property
    def full_sequence(self) -> bool:
        return self.phase in FULL_SEQUENCE_PHASES

    def validate(self, cfg) -> "ExecutionPlan":
        """Fail loudly when the plan cannot execute ``cfg``; returns self."""
        if self.dual_branch:
            self._validate_dual_branch(cfg)
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
