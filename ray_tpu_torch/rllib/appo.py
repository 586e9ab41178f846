"""APPO: asynchronous PPO — IMPALA's decoupled sampling driving PPO's
clipped-surrogate objective; the port of ``ray_tpu/rllib/appo.py``.

As in the reference (whose APPOConfig subclasses IMPALAConfig), the only
structural deltas from :class:`.impala.IMPALA` are the epoch count and
PPO-leaning default hyperparameters.
"""
from __future__ import annotations

from .impala import IMPALA, IMPALAConfig


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.num_epochs = 2          # unlike IMPALA's single pass
        self.clip_param = 0.2
        self.vtrace_rho_clip = 1.0
        self.minibatch_size = 256


class APPO(IMPALA):
    def _num_epochs(self) -> int:
        return self.config.num_epochs
