"""Deterministic token pipeline for LM training (the port's own copy of
``repro.data.pipeline``: numpy only, so its batches are bit-equal to the
reference's).

Requirements at fleet scale: (1) bitwise-deterministic batches as a pure
function of (seed, step) — restarts and elastic resizes revisit exactly
the data they should, with no pipeline state to checkpoint; (2) shard
awareness — each data-parallel rank materializes only its slice;
(3) a file-backed mode (memmapped token arrays) with the same interface.

The synthetic source is a mixture of Zipf-distributed unigrams with a
Markov component — enough structure that a ~100M model visibly learns,
while requiring no external assets.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch: int  # global batch
    seq_len: int
    seed: int = 0
    source: str = "synthetic"  # synthetic | file
    path: str | None = None
    _tokens: np.ndarray | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.source == "file":
            if not self.path:
                raise ValueError("file source needs path")
            self._tokens = np.load(self.path, mmap_mode="r")

    # ------------------------------------------------------------ access

    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        toks = self.batch_slice(step, rank=0, world=1)
        return toks

    def batch_slice(self, step: int, *, rank: int, world: int) -> dict:
        """The (batch/world)-sized slice owned by data-parallel ``rank``."""
        if self.batch % world:
            raise ValueError(f"batch {self.batch} not divisible by {world}")
        per = self.batch // world
        if self.source == "file":
            toks = self._file_batch(step, rank, per)
        else:
            toks = self._synth_batch(step, rank, per)
        return {"tokens": toks}

    def _synth_batch(self, step, rank, per):
        out = np.empty((per, self.seq_len), np.int32)
        for i in range(per):
            # one RNG per (step, global row): restart/elastic invariant
            row = rank * per + i
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, row]))
            out[i] = self._synth_row(rng)
        return out

    def _synth_row(self, rng):
        V = self.vocab_size
        S = self.seq_len
        # Zipf unigram base
        base = rng.zipf(1.3, size=S).astype(np.int64) % V
        # Markov component: with p=0.5 repeat previous token + small delta
        rep = rng.random(S) < 0.5
        delta = rng.integers(0, 4, S)
        toks = base.copy()
        for t in range(1, S):
            if rep[t]:
                toks[t] = (toks[t - 1] + delta[t]) % V
        return toks.astype(np.int32)

    def _file_batch(self, step, rank, per):
        n = self._tokens.shape[0]
        out = np.empty((per, self.seq_len), np.int32)
        for i in range(per):
            row = rank * per + i
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, row]))
            start = int(rng.integers(0, max(n - self.seq_len, 1)))
            out[i] = np.asarray(
                self._tokens[start:start + self.seq_len], np.int32)
        return out


def embeds_pipeline(d_model: int, batch: int, seq_len: int, seed: int = 0):
    """Frontend-stub pipeline for audio/VLM archs: deterministic
    (B, S, d_model) float32 'embeddings' plus integer labels."""

    def get(step: int, vocab_size: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, 77]))
        return {
            "embeds": rng.normal(
                size=(batch, seq_len, d_model)).astype(np.float32),
            "labels": rng.integers(
                0, vocab_size, size=(batch, seq_len)).astype(np.int32),
        }

    return get
