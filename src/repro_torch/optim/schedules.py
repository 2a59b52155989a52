"""LR schedules: cosine, one-cycle (paper Fig 9 / Cramming setting), and WSD
(warmup-stable-decay; minicpm-2b's native schedule, arXiv:2404.06395).

Port of ``repro/optim/schedules.py``.  Each schedule is a function of the
integer step returning a Python float; like the reference's ``jnp.float32``
arithmetic it computes in fp32 (numpy), so the two agree to an fp32
rounding or two (numpy's and XLA's fp32 ``cos`` may differ in the last
place).
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def warmup_cosine(peak, total_steps, warmup=0.01, floor=0.1):
    w = max(int(total_steps * warmup), 1)

    def f(step):
        step = _F(step)
        if step < w:
            return float(_F(peak) * step / _F(w))
        t = np.clip((step - _F(w)) / _F(max(total_steps - w, 1)), _F(0),
                    _F(1))
        c = np.cos(_F(np.pi) * t, dtype=_F)
        return float(_F(peak) * (_F(floor) + _F((1 - floor) * 0.5)
                                 * (_F(1) + c)))
    return f


def one_cycle(peak, total_steps, pct_up=0.3):
    up = max(int(total_steps * pct_up), 1)

    def f(step):
        step = _F(step)
        if step < up:
            return float(_F(peak) * step / _F(up))
        t = (step - _F(up)) / _F(max(total_steps - up, 1))
        return float(_F(peak) * np.clip(_F(1) - t, _F(0), _F(1)))
    return f


def wsd(peak, total_steps, warmup=0.05, decay=0.1, floor=0.1):
    """Warmup-Stable-Decay."""
    w = max(int(total_steps * warmup), 1)
    d_start = int(total_steps * (1 - decay))

    def f(step):
        step = _F(step)
        if step < w:
            return float(_F(peak) * step / _F(w))
        if step < d_start:
            return float(_F(peak))
        t = np.clip((step - _F(d_start)) / _F(max(total_steps - d_start, 1)),
                    _F(0), _F(1))
        return float(_F(peak) * (_F(1) - _F(1 - floor) * t))
    return f
