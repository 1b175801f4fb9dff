"""Synthetic batches for the LM and DIN paths (twin of ``repro.data.pipeline``).

Numpy only, written draw for draw like the JAX package's module, so the
same seed gives the same arrays: a Zipf token stream with local n-gram
structure for the LMs and click batches for DIN. Batches stay numpy; the
caller moves them to its device. (The GNN features and the multi-host
batch slice come with the GNN and multi-device slices.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class LmDataConfig:
    vocab: int = 1024
    seq_len: int = 128
    batch: int = 8
    zipf_a: float = 1.2
    ngram: int = 3
    seed: int = 0


def lm_token_stream(cfg: LmDataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite batches with learnable n-gram structure.

    Token t is a deterministic hash of the previous ``ngram−1`` tokens with
    probability 0.8, else a fresh Zipf draw.
    """
    rng = np.random.default_rng(cfg.seed)
    a, v = cfg.zipf_a, cfg.vocab

    def zipf(shape):
        z = rng.zipf(a, size=shape)
        return np.minimum(z - 1, v - 1).astype(np.int32)

    while True:
        toks = np.empty((cfg.batch, cfg.seq_len + 1), dtype=np.int32)
        toks[:, : cfg.ngram] = zipf((cfg.batch, cfg.ngram))
        fresh = zipf((cfg.batch, cfg.seq_len + 1))
        use_hash = rng.random((cfg.batch, cfg.seq_len + 1)) < 0.8
        for t in range(cfg.ngram, cfg.seq_len + 1):
            ctx = toks[:, t - cfg.ngram + 1 : t]
            hashed = (ctx.astype(np.int64) * np.array([31, 17])[: ctx.shape[1]]).sum(1) % v
            toks[:, t] = np.where(use_hash[:, t], hashed.astype(np.int32), fresh[:, t])
        yield {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }


def din_batch(
    batch: int, seq_len: int, n_items: int, n_cats: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    hist_len = rng.integers(1, seq_len + 1, size=batch)
    mask = (np.arange(seq_len)[None, :] < hist_len[:, None]).astype(np.float32)
    return {
        "hist_items": rng.integers(0, n_items, size=(batch, seq_len)).astype(np.int32),
        "hist_cats": rng.integers(0, n_cats, size=(batch, seq_len)).astype(np.int32),
        "hist_mask": mask,
        "target_item": rng.integers(0, n_items, size=batch).astype(np.int32),
        "target_cat": rng.integers(0, n_cats, size=batch).astype(np.int32),
        "label": rng.integers(0, 2, size=batch).astype(np.int32),
    }


def din_stream(batch: int, seq_len: int, n_items: int, n_cats: int, seed: int = 0):
    """Synthetic CTR stream whose label correlates with the overlap of the
    history's categories and the target's."""
    rng = np.random.default_rng(seed)
    i = 0
    while True:
        b = din_batch(batch, seq_len, n_items, n_cats, seed=seed + i)
        overlap = (b["hist_cats"] == b["target_cat"][:, None]).mean(axis=1)
        p = 1 / (1 + np.exp(-(overlap * 8 - 1)))
        b["label"] = (rng.random(batch) < p).astype(np.int32)
        yield b
        i += 1

