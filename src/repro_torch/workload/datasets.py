"""Deterministic synthetic token pipeline for the training example (a copy
of ``repro/workload/datasets.py``: numpy only, the same batches for the
same ``DataConfig``).

Generates a reproducible stream of pseudo-text token batches: a mixture of
Zipf-distributed unigram draws and short repeated n-gram motifs so the loss
actually decreases (there is learnable structure), without any external data.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 512
    motif_prob: float = 0.5


def token_batches(cfg: DataConfig) -> Iterator[dict]:
    """Yields {'inputs': (B,S) int32, 'labels': (B,S) int32} forever."""
    rng = np.random.default_rng(cfg.seed)
    motifs = rng.integers(0, cfg.vocab,
                          size=(cfg.n_motifs, cfg.motif_len)).astype(np.int32)
    while True:
        seqs = np.empty((cfg.batch, cfg.seq_len + 1), np.int32)
        for b in range(cfg.batch):
            pos = 0
            buf = np.empty(cfg.seq_len + 1 + cfg.motif_len + 12, np.int32)
            while pos < cfg.seq_len + 1:
                if rng.random() < cfg.motif_prob:
                    m = motifs[rng.integers(cfg.n_motifs)]
                    buf[pos: pos + cfg.motif_len] = m
                    pos += cfg.motif_len
                else:
                    n = int(rng.integers(2, 12))
                    draws = rng.zipf(cfg.zipf_a, size=n) % cfg.vocab
                    buf[pos: pos + n] = draws[: len(buf) - pos]
                    pos += n
            seqs[b] = buf[: cfg.seq_len + 1]
        yield {"inputs": seqs[:, :-1], "labels": seqs[:, 1:]}
