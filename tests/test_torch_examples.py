"""The port's example twins (``examples/torch_*.py``) on the CPU at a small
size, each ``main(argv)`` run from a temporary working directory with its
output there, so no tracked file is written:

* ``torch_train_fal_vs_baseline``: 3 steps a mode at batch 4 x 32 tokens;
  its JSON has the reference's schema (the modes of
  ``experiments/train_fal_vs_baseline.json``, each with ``final_loss``,
  ``wall_s`` and ``curve``).
* ``torch_quickstart``: 3 trainer steps and the TP demo over 2 gloo CPU
  ranks; fal's forward all-reduces below preln's (5 and 8 over 4 blocks),
  and under sequence parallelism fal's reduce-scatter bytes half preln's.
* ``torch_serve_requests``: the example's own equalities (batched == lone,
  capped == uncapped, prefix hit == cold, dual == sequential on the CPU),
  the plain paths, the trace, the full-prompt hit with no prefill token and
  its copy-on-write, and int8 pages under a third of fp32's bytes.
"""
import importlib.util
import json
import pathlib

import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401

from repro_torch.core import tp
from repro_torch.kernels import ops
from repro_torch.obs.trace import validate_chrome_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_fal_vs_baseline_schema(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "curves.json"
    res = _example("torch_train_fal_vs_baseline").main(
        ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
         "--out", str(out)])
    ref = json.loads((ROOT / "experiments" /
                      "train_fal_vs_baseline.json").read_text())
    got = json.loads(out.read_text())
    assert list(got) == list(ref) == list(res)
    for mode, r in got.items():
        assert set(r) == set(ref[mode]) == {"final_loss", "wall_s", "curve"}
        assert [s for s, _ in r["curve"]] == [0, 1, 2]
        assert all(isinstance(x, float) and x == x for _, x in r["curve"])
        assert r["final_loss"] == res[mode]["final_loss"]


def test_quickstart_counts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = _example("torch_quickstart").main(
        ["--device", "cpu", "--steps", "3", "--tp", "2"])
    assert res["logits_shape"] == (4, 64, 512)
    assert [h["step"] for h in res["history"]] == [0, 2]
    fal, preln = res["tp"]["fal"], res["tp"]["preln"]
    assert tp.count(fal, "all-reduce") == 5
    assert tp.count(preln, "all-reduce") == 8
    assert tp.count(fal, "all-reduce") < tp.count(preln, "all-reduce")
    rs = {m: tp.count(res["tp"][f"{m}_sp"], "reduce-scatter", what="bytes")
          for m in ("fal", "preln")}
    assert 2 * rs["fal"] == rs["preln"] > 0
    assert sum(res["rank_launches"].values()) == 0      # CPU: plain versions


def test_serve_requests_equalities(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trace = tmp_path / "trace.json"
    res = _example("torch_serve_requests").main(
        ["--device", "cpu", "--trace", str(trace)])
    assert res["batched_eq_lone"] and res["capped_eq_uncapped"]
    assert res["dual_eq_sequential"]
    assert res["paths"] == {"paged_packed_attention": ops.PLAIN,
                            "fused_ln_add": ops.PLAIN}
    assert res["prefix_hits"] == 5 and res["cow_copies"] >= 1
    assert res["full_hit_prefill_tokens"] == 0
    pb = res["page_bytes"]
    assert pb["int8"] < pb["float32"] / 3
    assert validate_chrome_trace(json.loads(trace.read_text())) > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trace.json"]


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_requests",
                                  "torch_train_fal_vs_baseline"])
def test_examples_default_to_the_card(name, monkeypatch, tmp_path):
    """Without ``--device`` an example asks for the card, and without one
    it raises before doing anything."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(["--steps", "1"] if name != "torch_serve_requests"
                            else [])
    assert list(tmp_path.iterdir()) == []
