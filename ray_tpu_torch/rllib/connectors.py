"""Connectors V2: composable env↔module transform pipelines, numpy on
the host — copied from ``ray_tpu/rllib/connectors.py`` (framework-neutral;
the port keeps its own copy).

Small pure transforms chained into a pipeline the env runner applies to
raw observations before module inference. State (e.g. frame stacks)
lives in the connector, keyed by vector-env slot.
"""
from __future__ import annotations

from typing import List

import numpy as np


class ConnectorV2:
    """One transform; ``__call__(obs [N, ...], slots) -> obs [N, ...]``.

    ``slots`` names the vector-env slot of each row (stateful connectors
    key their per-episode state on it); None means ``range(N)``.
    """

    def __call__(self, obs: np.ndarray, slots=None) -> np.ndarray:
        raise NotImplementedError

    def reset(self, slot: int) -> None:
        """Episode boundary for one vector-env slot (stateful connectors)."""

    def out_shape(self, in_shape) -> tuple:
        """Probe the post-transform observation shape."""
        probe = np.zeros((1,) + tuple(in_shape), np.float32)
        shape = tuple(self(probe).shape[1:])
        self.reset(0)  # drop any state the probe created in slot 0
        return shape


class FlattenObs(ConnectorV2):
    def __call__(self, obs, slots=None):
        return np.asarray(obs, np.float32).reshape(len(obs), -1)


class NormalizeObs(ConnectorV2):
    """Fixed affine normalization (e.g. uint8 images → [0, 1])."""

    def __init__(self, scale: float = 1.0, offset: float = 0.0):
        self.scale = scale
        self.offset = offset

    def __call__(self, obs, slots=None):
        return (np.asarray(obs, np.float32) - self.offset) * self.scale


class FrameStack(ConnectorV2):
    """Stack the last k frames along the channel axis ([N,H,W,C*k])."""

    def __init__(self, k: int = 4):
        self.k = k
        self._stacks: dict = {}

    def __call__(self, obs, slots=None):
        obs = np.asarray(obs, np.float32)
        slots = range(len(obs)) if slots is None else slots
        out = []
        for i, frame in zip(slots, obs):
            stack = self._stacks.get(i)
            if stack is None:
                stack = [frame] * self.k
            else:
                stack = stack[1:] + [frame]
            self._stacks[i] = stack
            out.append(np.concatenate(stack, axis=-1))
        return np.stack(out)

    def reset(self, slot: int):
        self._stacks.pop(slot, None)


class ConnectorPipeline(ConnectorV2):
    def __init__(self, connectors: List[ConnectorV2]):
        self.connectors = list(connectors)

    def __call__(self, obs, slots=None):
        for c in self.connectors:
            obs = c(obs, slots)
        return obs

    def reset(self, slot: int):
        for c in self.connectors:
            c.reset(slot)
