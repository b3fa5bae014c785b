"""Deterministic synthetic token pipeline (shard-aware, infinite).

Real corpora are unavailable offline; the pipeline generates a mixture of
Zipf-distributed tokens with injected copy/repeat structure so the LM has
learnable signal (loss decreases), which the end-to-end examples rely on.

A copy of the JAX package's ``repro.data.pipeline``: the same numpy draws
from the same seed, so the two give the same batches.  ``rows`` selects
some of each global batch's rows (a data rank's, ``step.rows``): the draws
stay those of the whole batch, in the same order, so each row is the JAX
pipeline's row of that index, while the modal embeddings are built for
the selected rows alone.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticTokens:
    """Iterator of {tokens, labels[, modal_embeds]} numpy batches."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, zipf_a: float = 1.2,
                 rows: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.batch = global_batch
        self.rows = None if rows is None else np.asarray(rows, np.int64)
        self.n_rows = global_batch if rows is None else len(self.rows)
        # text positions exclude the modal prefix
        self.text_len = seq_len - cfg.num_modal_tokens
        assert self.text_len > 1, "seq_len must exceed modal prefix"
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        # fixed random projection used as fake frontend embeddings
        if cfg.num_modal_tokens:
            self._modal = self.rng.standard_normal(
                (cfg.num_modal_tokens, cfg.d_model)).astype(np.float32) * 0.02

    def _sample_tokens(self) -> np.ndarray:
        V = self.cfg.vocab_size
        z = self.rng.zipf(self.zipf_a, size=(self.batch, self.text_len))
        toks = (z - 1) % V
        # copy structure: second half repeats the first half for 30% of rows
        half = self.text_len // 2
        rows = self.rng.random(self.batch) < 0.3
        toks[rows, half:2 * half] = toks[rows, :half]
        return toks.astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        toks = self._sample_tokens()
        if self.rows is not None:
            toks = toks[self.rows]
        out = {"tokens": toks}
        if self.cfg.num_modal_tokens:
            out["modal_embeds"] = np.broadcast_to(
                self._modal[None], (self.n_rows,) + self._modal.shape).copy()
            # labels span the full sequence; modal positions get label 0
            pad = np.zeros((self.n_rows, self.cfg.num_modal_tokens), np.int32)
            out["labels"] = np.concatenate([pad, toks], axis=1)
        else:
            out["labels"] = toks
        return out
