"""Deterministic, host-sharded, exactly-resumable LM data pipeline (a copy
of ``repro/data/pipeline.py``, numpy only: ``batch_at(step)`` gives the same
arrays as the JAX package's for the same ``(seed, step)``).

Principles for 1000+ node runs:
  * every batch is a pure function of (seed, step, host_slice) — no iterator
    state beyond the integer ``step``, so checkpoint/restore replays exactly
    and elastic restarts with a different host count stay consistent (the
    global batch is always materialized by global index, each host takes its
    addressable slice)
  * corpus mode: byte-level tokenization of any file tree, windows sampled
    by a counter-based RNG (no shuffling state to lose)
  * synthetic mode: learnable Zipf+bigram stream
  * ``frontend``: the vlm's patches or the encoder-decoder's frames (the
    stubbed frontend's embeddings, ``synthetic.frontend_shape``), standard
    normal, drawn from each row's own RNG after its tokens, so the tokens
    stay the JAX package's and a host slice draws the same rows
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus_path: Optional[str] = None     # None -> synthetic
    vocab_size: int = 256                 # byte tokenizer default


class ByteCorpus:
    """Memory-mapped byte-level corpus over a file or directory."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            files = sorted(
                os.path.join(r, f) for r, _, fs in os.walk(path) for f in fs)
            blobs = [np.fromfile(f, dtype=np.uint8) for f in files]
            self.data = np.concatenate(blobs) if blobs else np.zeros(1, np.uint8)
        else:
            self.data = np.memmap(path, dtype=np.uint8, mode="r")
        if len(self.data) < 2:
            raise ValueError(f"corpus at {path} is empty")

    def window(self, start: int, length: int) -> np.ndarray:
        n = len(self.data)
        idx = (start + np.arange(length)) % (n - 1)
        return np.asarray(self.data[idx], dtype=np.int32)


def _counter_rng(seed: int, step: int, row: int) -> np.random.Generator:
    h = hashlib.blake2s(f"{seed}/{step}/{row}".encode(), digest_size=8)
    return np.random.default_rng(int.from_bytes(h.digest(), "little"))


class LMDataSource:
    """Stateless batch factory; ``state`` is just the step counter.
    ``frontend`` (key, row shape) adds that float32 input to every row."""

    def __init__(self, cfg: DataConfig, corpus: Optional[ByteCorpus] = None,
                 frontend: Optional[Tuple[str, Tuple[int, ...]]] = None):
        self.cfg = cfg
        self.corpus = corpus or (ByteCorpus(cfg.corpus_path)
                                 if cfg.corpus_path else None)
        self.frontend = frontend

    def batch_at(self, step: int, lo: int = 0, hi: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """Rows [lo, hi) of the global batch for ``step`` (host slicing)."""
        cfg = self.cfg
        hi = cfg.global_batch if hi is None else hi
        s = cfg.seq_len
        toks = np.empty((hi - lo, s + 1), np.int32)
        if self.frontend is not None:
            key, shape = self.frontend
            front = np.empty((hi - lo,) + tuple(shape), np.float32)
        for i, row in enumerate(range(lo, hi)):
            rng = _counter_rng(cfg.seed, step, row)
            if self.corpus is not None:
                start = int(rng.integers(0, len(self.corpus.data) - 1))
                toks[i] = self.corpus.window(start, s + 1)
            else:
                toks[i] = _synthetic_row(rng, s + 1, cfg.vocab_size)
            if self.frontend is not None:
                front[i] = rng.standard_normal(shape, np.float32)
        out = {"tokens": toks[:, :-1],
               "labels": toks[:, 1:],
               "mask": np.ones((hi - lo, s), np.float32)}
        if self.frontend is not None:
            out[key] = front
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Tuple[int, Dict]]:
        step = start_step
        while True:
            yield step, self.batch_at(step)
            step += 1


def _synthetic_row(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """Zipf marginals + deterministic bigram."""
    out = np.empty(n, np.int64)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = (1.0 / ranks); p /= p.sum()
    prev = int(rng.choice(vocab, p=p))
    for t in range(n):
        if t % 7 == 0:
            prev = int(rng.choice(vocab, p=p))
        else:
            prev = (prev * 31 + 7) % vocab
        out[t] = prev
    return out.astype(np.int32)
