"""Token selection for the port's serving engine: greedy only.

Port of ``repro/serve/sampling.py``'s ``SamplingParams`` and its greedy
branch.  ``torch.argmax`` returns the first maximum, as ``jnp.argmax``
does, so greedy streams tie-break identically.  Seeded temperature / top-k
/ top-p sampling draws Gumbel noise from ``jax.random.fold_in`` keys
(``sampling.py:83``); reproducing those bits needs a threefry port, which
comes in a later slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0          # 0 -> greedy (argmax)
    top_k: int = 0                    # 0 -> disabled
    top_p: float = 1.0                # >= 1 -> disabled
    seed: int = 0

    @staticmethod
    def greedy() -> "SamplingParams":
        return SamplingParams()


def check_supported(sp: SamplingParams):
    if sp.temperature > 0.0:
        raise NotImplementedError(
            "temperature > 0 sampling needs the threefry-seeded sampler, "
            "which comes in a later slice of the PyTorch port")


def greedy(logits):
    """logits (..., V) -> int32 ids of the first maximum, computed in fp32."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)
