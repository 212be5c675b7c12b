"""Deterministic synthetic data with exact-resume cursors,
``repro/training/data.py`` in PyTorch.

A structured token stream (a periodic pattern mixed into uniform noise:
learnable, so the loss falls) is drawn deterministically from (seed,
cursor).  The pipeline is stateless: ``batch_at(cursor)`` is a pure
function, so resuming after a preemption needs only the cursor, which the
checkpoint manifest commits through the control plane beside the weights.

Each global row r of the batch at ``cursor`` has its own generator, a numpy
Philox stream keyed by (seed, cursor, r) through
``repro_torch.montecarlo.rng.derive``, so host h of H, which takes rows
``h::H``, draws exactly its slice of the global batch.  Batches are CPU
tensors made on the host (int64 token ids; bf16 frontend embeddings); the
trainer moves them to the model's device.  The draws are Philox, not JAX's
threefry: the stream is the same in distribution only (ROADMAP.md, "Draws
are the seam").
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.montecarlo import rng

_ROWS, _FRONTEND = 0, 1          # rng domains under a cursor's key


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    structure: int = 97        # period of the synthetic structure


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _cursor_key(self, cursor: int) -> int:
        return rng.derive(rng.root(self.cfg.seed), rng.CHUNK_DOMAIN, cursor)

    def batch_at(self, cursor: int, host: int = 0, n_hosts: int = 1
                 ) -> Dict[str, torch.Tensor]:
        """The global batch at ``cursor`` (this host's rows h::H): tokens
        and labels (rows, seq_len) int64, labels the tokens shifted by
        one."""
        c = self.cfg
        key = self._cursor_key(cursor)
        toks = np.stack([self._row(rng.derive(key, _ROWS, r))
                         for r in range(host, c.global_batch, n_hosts)])
        toks = torch.from_numpy(toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _row(self, key: int) -> np.ndarray:
        """seq_len + 1 tokens: each the periodic token (position + phase)
        mod ``structure`` mod vocab with probability 0.7, else uniform in
        [0, vocab)."""
        c = self.cfg
        g = np.random.Generator(np.random.Philox(key))
        base = g.integers(0, c.vocab, c.seq_len + 1)
        phase = g.integers(0, c.structure)
        pos = np.arange(c.seq_len + 1)
        periodic = (pos + phase) % c.structure % c.vocab
        use_periodic = g.random(c.seq_len + 1) < 0.7
        return np.where(use_periodic, periodic, base).astype(np.int64)

    def frontend_batch_at(self, cursor: int, d_model: int, frontend: str,
                          vision_tokens: int = 0, host: int = 0,
                          n_hosts: int = 1) -> Dict[str, torch.Tensor]:
        """Batches for the stub-frontend architectures: audio frames
        (B, seq_len, d_model) or vision patches (B, vision_tokens, d_model),
        standard normal in bf16, with the token batch cut to fit."""
        c = self.cfg
        base = self.batch_at(cursor, host, n_hosts)
        B = base["tokens"].shape[0]
        g = np.random.Generator(np.random.Philox(
            rng.derive(self._cursor_key(cursor), _FRONTEND, host)))

        def emb(rows):
            return torch.from_numpy(g.standard_normal(
                (B, rows, d_model), dtype=np.float32)).to(torch.bfloat16)

        if frontend == "audio_frames":
            return {"frame_emb": emb(c.seq_len),
                    "labels": base["labels"][:, :c.seq_len]}
        if frontend == "vision_patches":
            V = vision_tokens
            return {"patch_emb": emb(V),
                    "tokens": base["tokens"][:, :c.seq_len - V],
                    "labels": base["labels"][:, :c.seq_len - V]}
        raise ValueError(frontend)
