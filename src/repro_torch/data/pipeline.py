"""Batch pipeline: contiguous next-token-prediction windows over a token
stream (the reference's ``data/pipeline.py``), as tensors on an explicit
device.

Every call draws the same global batch from ``numpy``'s
``default_rng(seed)`` as the reference's ``Batches`` does. On a data group
of ``dp`` ranks (``rows=(r, dp)``) data rank r keeps rows ``[r B/dp, (r+1)
B/dp)`` of it: the rows ``NamedSharding(P(data))`` would place on it. Every
rank draws the whole batch, so the ranks' streams never part.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Batches"]


class Batches:
    def __init__(self, tokens: np.ndarray, batch_size: int, seq_len: int, *, seed: int = 0,
                 device: str | torch.device = "cuda", rows: Tuple[int, int] = (0, 1)):
        rank, n = rows
        if batch_size % n or not 0 <= rank < n:
            raise ValueError(f"a batch of {batch_size} rows does not split into {n} data "
                             f"ranks' equal shares (rank {rank})")
        self.tokens = tokens
        self.batch = batch_size
        self.seq = seq_len
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.rows = slice(rank * batch_size // n, (rank + 1) * batch_size // n)
        self.n_windows = (len(tokens) - 1) // seq_len

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next()

    def next(self) -> Dict[str, torch.Tensor]:
        """``{"tokens", "targets"}`` (this rank's rows, seq_len) int32."""
        starts = self.rng.integers(0, len(self.tokens) - self.seq - 1, self.batch)[self.rows]
        x = np.stack([self.tokens[s:s + self.seq] for s in starts])
        y = np.stack([self.tokens[s + 1:s + self.seq + 1] for s in starts])
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)
        return {"tokens": to(x), "targets": to(y)}
