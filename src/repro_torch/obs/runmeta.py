"""Run-metadata stamping for benchmark artifacts.

Port of ``repro/obs/runmeta.py``: the stamp says WHAT produced a number:
the git sha, the torch and CUDA versions, the device's name and count, on
the card its power limit (an H100 set below 700 W runs slower under load),
the python version and platform, and the runner's timestamp.  Without it a
committed number cannot be told from a CPU run or a stale artifact.
"""
from __future__ import annotations

import platform
import subprocess
import sys

import torch


def _git_sha(repo_dir: str = ".") -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"], cwd=repo_dir,
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            sha = out.stdout.strip()
            dirty = subprocess.run(
                ["git", "status", "--porcelain"], cwd=repo_dir,
                capture_output=True, text=True, timeout=10)
            if dirty.returncode == 0 and dirty.stdout.strip():
                sha += "-dirty"
            return sha
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "unknown"


def _nvidia_smi() -> str:
    """``name, power.limit`` of the visible cards as ``nvidia-smi`` prints
    them, one line a card; "unknown" when it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 else "unknown"


def run_metadata(timestamp: float = None, repo_dir: str = ".",
                 dispatch_paths: dict = None) -> dict:
    """Stamp for a benchmark run.  ``timestamp`` is passed in by the runner;
    ``dispatch_paths`` is ``kernels.ops.dispatch_paths()`` when the run
    exercised kernels.  On a machine without a card the device is the CPU
    (``device_kind`` "cpu") and there is no ``power_limit`` key."""
    cuda = torch.cuda.is_available()
    meta = {
        "git_sha": _git_sha(repo_dir),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
    }
    if cuda:
        meta["power_limit"] = _nvidia_smi()
    if timestamp is not None:
        meta["timestamp"] = timestamp
    if dispatch_paths is not None:
        meta["dispatch_paths"] = dict(dispatch_paths)
    return meta
