"""Deterministic synthetic token pipeline.

Ports ``src/repro/data/pipeline.py``, numpy only, with byte-identical
arrays: ``batch_at(step)`` is a pure function of (seed, step), so after a
WRATH checkpoint/restart the data order resumes exactly.

The token stream is a learnable Markov-ish process: the next token
depends on the current one through a fixed random permutation plus
noise, so small models actually reduce the loss.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig


class SyntheticTokens:
    def __init__(self, vocab_size: int, batch: int, seq_len: int, *,
                 seed: int = 0, noise: float = 0.1):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab_size)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=self.batch)
        noise_mask = rng.random((self.batch, self.seq)) < self.noise
        noise_tok = rng.integers(0, self.vocab, size=(self.batch, self.seq))
        for t in range(self.seq):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def batch_for(cfg: ModelConfig, batch: int, seq_len: int, step: int, *,
              seed: int = 0) -> dict[str, np.ndarray]:
    """Arch-aware batch (token models get tokens; embed models get frames)."""
    out: dict[str, np.ndarray] = {}
    rng = np.random.default_rng((seed << 20) ^ step)
    if cfg.encoder_layers:
        out["enc_embeds"] = rng.standard_normal(
            (batch, seq_len, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.input_kind == "embeds" and not cfg.encoder_layers:
        out["embeds"] = rng.standard_normal(
            (batch, seq_len, cfg.d_model)).astype(np.float32) * 0.02
        out["targets"] = rng.integers(
            0, cfg.vocab_size, size=(batch, seq_len)).astype(np.int32)
        return out
    pipe = SyntheticTokens(cfg.vocab_size, batch, seq_len, seed=seed)
    out.update(pipe.batch_at(step))
    return out
