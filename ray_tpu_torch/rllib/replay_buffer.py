"""Replay buffers: uniform ring + proportional prioritized, numpy on the
host — copied from ``ray_tpu/rllib/replay_buffer.py`` (framework-neutral;
the port keeps its own copy).

Transition-level storage with O(1) append, uniform or
priority-proportional sampling, importance weights and TD-error priority
updates, over vectorized numpy cumulative sums.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class ReplayBuffer:
    """Uniform FIFO transition buffer over column arrays."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self._cols: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Append a batch of transitions; returns their slot indices."""
        n = len(next(iter(batch.values())))
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = v
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        return idx

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, self._size, batch_size)
        out = {k: v[idx] for k, v in self._cols.items()}
        out["_indices"] = idx
        return out


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (alpha/beta annealing).

    ``sample`` returns importance weights under ``"weights"``; callers
    push TD errors back via ``update_priorities``.
    """

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._prio = np.zeros((capacity,), np.float64)
        self._max_prio = 1.0

    def add(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        idx = super().add(batch)
        self._prio[idx] = self._max_prio  # new data: max priority
        return idx

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        p = self._prio[:self._size] ** self.alpha
        total = p.sum()
        if total <= 0:
            return super().sample(batch_size)
        probs = p / total
        idx = self.rng.choice(self._size, batch_size, p=probs)
        weights = (self._size * probs[idx]) ** (-self.beta)
        weights /= weights.max()
        out = {k: v[idx] for k, v in self._cols.items()}
        out["_indices"] = idx
        out["weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray, eps: float = 1e-6):
        prio = np.abs(td_errors) + eps
        self._prio[indices] = prio
        self._max_prio = max(self._max_prio, float(prio.max()))
