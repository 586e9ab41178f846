"""RLModule: policy + value network with a numpy rollout forward and a
torch learner forward — the port of ``ray_tpu/rllib/rl_module.py``.

Env runners do rollout inference on the host with the NUMPY path (the
card belongs to the learners); learners run the same math in torch on
their device. One parameter tree serves both: nested dicts and lists of
numpy arrays on the host, of tensors in a learner.
:func:`params_to_torch` and :func:`params_to_numpy` carry it across, so
the reference's numpy initialisers (copied here) give both packages the
same weights for the same seed.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


class RLModuleSpec:
    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Tuple[int, ...] = (64, 64),
                 obs_shape: Tuple[int, ...] = (),
                 conv: bool = False,
                 module_cls: Any = None,
                 continuous: bool = False,
                 action_low=None, action_high=None):
        self.obs_dim = obs_dim
        # For continuous (Box) spaces num_actions is the action dimension.
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.obs_shape = tuple(obs_shape)  # (H, W, C) for conv torsos
        self.conv = conv
        self.module_cls = module_cls
        self.continuous = continuous
        self.action_low = action_low
        self.action_high = action_high

    def build(self, seed: int = 0):
        if self.module_cls is not None:
            return self.module_cls(self, seed)
        if self.conv:
            from .conv_module import ConvModule

            return ConvModule(self, seed)
        return DiscreteMLPModule(self, seed)


def dense_init(rng, fan_in: int, fan_out: int, scale=None) -> Params:
    """Scaled-normal dense layer init shared by every module family."""
    s = scale if scale is not None else np.sqrt(2.0 / fan_in)
    return {"w": (rng.standard_normal((fan_in, fan_out)) * s
                  ).astype(np.float32),
            "b": np.zeros((fan_out,), np.float32)}


def _init_mlp(spec: RLModuleSpec, seed: int) -> Params:
    rng = np.random.default_rng(seed)

    def dense(fan_in, fan_out, scale=None):
        return dense_init(rng, fan_in, fan_out, scale)

    sizes = (spec.obs_dim,) + spec.hidden
    # SEPARATE policy and value trunks: a shared trunk lets the large
    # unnormalized value loss swamp the policy features.
    return {
        "pi_hidden": [dense(sizes[i], sizes[i + 1])
                      for i in range(len(sizes) - 1)],
        "vf_hidden": [dense(sizes[i], sizes[i + 1])
                      for i in range(len(sizes) - 1)],
        "logits": dense(sizes[-1], spec.num_actions, scale=0.01),
        "value": dense(sizes[-1], 1, scale=1.0),
    }


def params_to_torch(tree, device) -> Any:
    """A parameter tree with every array leaf copied into a tensor on
    ``device`` (dtype kept; 0-d arrays become 0-d tensors)."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_torch(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)


def params_to_numpy(tree) -> Any:
    """A parameter tree with every tensor leaf copied into a host numpy
    array (a copy on the CPU too: rollout weights never alias a
    learner's tensors)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    return np.asarray(tree)


def module_forward(spec: "RLModuleSpec", params: Params, obs, xp=np):
    """Spec-dispatched (logits, value) forward shared by all learners;
    ``xp`` is numpy (rollouts) or torch (learners)."""
    if spec.conv:
        from .conv_module import conv_forward

        return conv_forward(params, obs, xp)
    return mlp_forward(params, obs, xp)


def mlp_forward(params: Params, obs, xp=np):
    """(logits, value) — ``xp`` is numpy on arrays (rollouts) or torch on
    tensors (learners): the same operations in the same order."""
    h = obs
    for layer in params["pi_hidden"]:
        h = xp.tanh(h @ layer["w"] + layer["b"])
    logits = h @ params["logits"]["w"] + params["logits"]["b"]
    hv = obs
    for layer in params["vf_hidden"]:
        hv = xp.tanh(hv @ layer["w"] + layer["b"])
    value = (hv @ params["value"]["w"] + params["value"]["b"])[..., 0]
    return logits, value


def sample_categorical(logits: np.ndarray, rng: np.random.Generator):
    """(actions, logp) of one categorical draw per row of ``logits``, the
    reference's rollout sampler (numpy)."""
    z = logits - logits.max(-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(-1, keepdims=True)
    actions = np.array([rng.choice(len(row), p=row) for row in p])
    logp = np.log(p[np.arange(len(actions)), actions] + 1e-20)
    return actions, logp


class DiscreteMLPModule:
    """Categorical-action module (CartPole-class tasks + Atari-on-MLP)."""

    def __init__(self, spec: RLModuleSpec, seed: int = 0):
        self.spec = spec
        self.params: Params = _init_mlp(spec, seed)

    # ------------------------------------------------- rollout (numpy)
    def forward_exploration(self, obs: np.ndarray, rng: np.random.Generator):
        logits, value = mlp_forward(self.params, obs, np)
        actions, logp = sample_categorical(logits, rng)
        return actions, logp, value

    def forward_inference(self, obs: np.ndarray):
        logits, _ = mlp_forward(self.params, obs, np)
        return logits.argmax(-1)

    def forward_values(self, obs: np.ndarray) -> np.ndarray:
        """Bootstrap values V(s) for the env runner's GAE tail."""
        _, value = mlp_forward(self.params, obs, np)
        return value

    # ------------------------------------------------------- weights
    def get_weights(self) -> Params:
        return self.params

    def set_weights(self, params: Params):
        self.params = params
