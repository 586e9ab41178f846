"""Offline RL data plumbing, numpy on the host — copied from
``ray_tpu/rllib/offline_data.py`` (framework-neutral; the port keeps its
own copy).

Accepted inputs everywhere: anything with a ``take_all()`` returning row
dicts (a Dataset), a list of row dicts, or a column dict of numpy arrays.
Transition columns are ``obs, actions, rewards, next_obs, dones`` (BC
only needs the first two).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

TRANSITION_KEYS = ("obs", "actions", "rewards", "next_obs", "dones")


def to_columns(data: Any, keys: Optional[Sequence[str]] = None,
               discrete_actions: bool = False) -> Dict[str, np.ndarray]:
    """Normalize any accepted offline-data input into column arrays."""
    if hasattr(data, "take_all"):          # ray_tpu.data Dataset
        data = data.take_all()
    if isinstance(data, list):             # row dicts
        if not data:
            raise ValueError("empty offline dataset")
        keys = tuple(keys or [k for k in TRANSITION_KEYS if k in data[0]])
        data = {k: [r[k] for r in data] for k in keys}
    keys = tuple(keys or [k for k in TRANSITION_KEYS if k in data])
    out: Dict[str, np.ndarray] = {}
    for k in keys:
        if k == "actions" and discrete_actions:
            out[k] = np.asarray(data[k], np.int64)
        else:
            out[k] = np.asarray(data[k], np.float32)
    sizes = {len(v) for v in out.values()}
    if len(sizes) != 1:
        raise ValueError(f"ragged offline columns: "
                         f"{ {k: len(v) for k, v in out.items()} }")
    return out


class OfflineData:
    """Shuffled minibatch iterator over logged transitions."""

    def __init__(self, data: Any, *, discrete_actions: bool = False,
                 seed: int = 0):
        self.cols = to_columns(data, discrete_actions=discrete_actions)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(next(iter(self.cols.values())))

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, len(self), size=batch_size)
        return {k: v[idx] for k, v in self.cols.items()}

    def epoch(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self)
        perm = self._rng.permutation(n)
        for lo in range(0, n, batch_size):
            idx = perm[lo:lo + batch_size]
            yield {k: v[idx] for k, v in self.cols.items()}


def rollout_to_rows(batch) -> list:
    """SampleBatch → row dicts suitable for ``ray_tpu.data.from_items``
    (the collection path: run a policy, log transitions, train offline)."""
    return [
        {"obs": np.asarray(batch["obs"][i]),
         "actions": np.asarray(batch["actions"][i]),
         "rewards": float(batch["rewards"][i]),
         "next_obs": np.asarray(batch["next_obs"][i]),
         "dones": float(batch["dones"][i])}
        for i in range(len(batch["obs"]))
    ]
