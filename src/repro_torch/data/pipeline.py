"""Token data pipeline (numpy only).

The port's own copy of ``repro/data/pipeline.py:22-98`` (``SyntheticMarkov``,
``MemmapTokens``, ``unigram_entropy``): the port imports nothing of
``repro``.  The same ``(seed, step, host_id)`` gives byte-identical batches
to the reference's.

Two sources:
* ``SyntheticMarkov`` — deterministic, learnable synthetic LM corpus (sparse
  Markov chain over the vocab).  A model that learns the transition table
  drives loss well below the unigram entropy, so quality benchmarks
  (bench_quality, paper Table 1 / Fig 9 analogues) produce meaningful curves
  without external datasets.
* ``MemmapTokens`` — production path: flat uint16/uint32 token file, memory
  mapped, sharded across hosts by ``(host_id, num_hosts)``.

Both yield dict batches ``{"tokens": (B, S) int32}`` deterministically from a
seed + step index (restart-safe: the stream is a pure function of the step).

Data parallelism in the port draws the GLOBAL batch on every rank
(``host_id=0, num_hosts=1``, as the reference's jitted trainer does) and
keeps this data rank's rows (``shard_rows``), so a run over any number of
data ranks trains on the batches a one-device run of the seed does.

whisper's mel / conv front end is a stub in both packages: its inputs are
frame embeddings, which neither token source makes.  ``stub_frames`` draws
a step's (B, n_enc_frames, d) from ``(seed, step)`` for the trainer, the
same on every rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticMarkov:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    branching: int = 4
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse transition table: each token -> `branching` successors
        self.table = rng.integers(0, self.vocab,
                                  size=(self.vocab, self.branching))
        probs = rng.random((self.vocab, self.branching)) + 0.1
        self.probs = probs / probs.sum(1, keepdims=True)

    def batch_at(self, step: int):
        rng = np.random.default_rng(
            (self.seed, step, self.host_id))
        B, S = self.batch // self.num_hosts, self.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, B)
        # vectorised Markov walk
        choices = rng.random((B, S))
        for t in range(1, S):
            cum = np.cumsum(self.probs[toks[:, t - 1]], axis=1)
            idx = (choices[:, t:t + 1] > cum).sum(1)
            toks[:, t] = self.table[toks[:, t - 1], idx]
        return {"tokens": toks}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class MemmapTokens:
    path: str
    seq_len: int
    batch: int
    seed: int = 0
    dtype: str = "uint16"
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        self.data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self.n_seqs = (len(self.data) - 1) // self.seq_len

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        B = self.batch // self.num_hosts
        # every host draws the same global permutation, takes its slice
        idx = rng.integers(0, self.n_seqs, self.batch)
        idx = idx[self.host_id * B:(self.host_id + 1) * B]
        toks = np.stack([
            np.asarray(self.data[i * self.seq_len:(i + 1) * self.seq_len + 1])
            for i in idx])
        return {"tokens": toks[:, :-1].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def stub_frames(cfg, batch, seed, step):
    """whisper's stubbed front end: (batch, n_enc_frames, d_model) fp32
    standard normal frame embeddings, a pure function of ``(seed,
    step)``."""
    rng = np.random.default_rng((seed, step))
    return rng.standard_normal((batch, cfg.n_enc_frames, cfg.d_model),
                               dtype=np.float32)


def shard_rows(batch, rank, n):
    """Data rank ``rank``'s rows ``[rank B/n, (rank+1) B/n)`` of every
    (B, ...) array of a global batch; B must divide by ``n``."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % n:
            raise ValueError(f"batch {k!r}: {B} rows do not split over {n} "
                             f"data-parallel ranks")
        out[k] = v[rank * (B // n):(rank + 1) * (B // n)]
    return out


def unigram_entropy(ds: SyntheticMarkov, n=50_000):
    """Reference entropy floor of the synthetic stream (nats/token)."""
    b = ds.batch_at(0)["tokens"].reshape(-1)[:n]
    _, counts = np.unique(b, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log(p)).sum())
