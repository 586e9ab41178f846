"""CNN RLModule: the Nature-DQN conv torso for image observations — the
port of ``ray_tpu/rllib/conv_module.py``.

Env-runner rollouts run the reference's pure-numpy forward (stride-trick
im2col, copied); learners run the same layers in torch through
``F.conv2d``. Observations are ``[B, H, W, C]`` float32 and the conv
weights stay HWIO arrays, the reference's layouts, so both paths share
one parameter tree: the torch path views an observation as NCHW over its
NHWC storage (channels-last, no copy), permutes each weight to an OIHW
view, and flattens the last conv's output in NHWC order as the reference
does. This is a layout change, not a kernel: the reference's convolutions
are ``lax.conv_general_dilated``, not Pallas.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .rl_module import dense_init, sample_categorical

Params = Dict[str, Any]

# (out_channels, kernel, stride) — the Nature-DQN torso.
NATURE_CONVS: Tuple[Tuple[int, int, int], ...] = (
    (32, 8, 4), (64, 4, 2), (64, 3, 1))


def _conv2d_np(x: np.ndarray, w: np.ndarray, stride: int) -> np.ndarray:
    """VALID conv, NHWC x HWIO → NHWC, via as_strided im2col."""
    B, H, W, C = x.shape
    K = w.shape[0]
    Ho = (H - K) // stride + 1
    Wo = (W - K) // stride + 1
    sB, sH, sW, sC = x.strides
    patches = np.lib.stride_tricks.as_strided(
        x, (B, Ho, Wo, K, K, C),
        (sB, sH * stride, sW * stride, sH, sW, sC), writeable=False)
    return np.tensordot(patches, w, axes=([3, 4, 5], [0, 1, 2]))


def _conv_forward_np(params: Params, obs: np.ndarray):
    h = obs
    for layer, (_, _, stride) in zip(params["convs"], NATURE_CONVS):
        h = _conv2d_np(h, layer["w"], stride) + layer["b"]
        h = np.maximum(h, 0.0)
    h = h.reshape(h.shape[0], -1)
    h = np.maximum(h @ params["torso"]["w"] + params["torso"]["b"], 0.0)
    logits = h @ params["logits"]["w"] + params["logits"]["b"]
    value = (h @ params["value"]["w"] + params["value"]["b"])[..., 0]
    return logits, value


def _conv_forward_torch(params: Params, obs: torch.Tensor):
    # torch.maximum against 0 (not relu): its gradient at a tie is 1/2,
    # as jnp.maximum's is, and an all-zero patch gives an exact 0.
    zero = obs.new_zeros(())
    x = obs.permute(0, 3, 1, 2)
    for layer, (_, _, stride) in zip(params["convs"], NATURE_CONVS):
        x = F.conv2d(x, layer["w"].permute(3, 2, 0, 1), layer["b"],
                     stride=stride)
        x = torch.maximum(x, zero)
    h = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    h = torch.maximum(h @ params["torso"]["w"] + params["torso"]["b"], zero)
    logits = h @ params["logits"]["w"] + params["logits"]["b"]
    value = (h @ params["value"]["w"] + params["value"]["b"])[..., 0]
    return logits, value


def conv_forward(params: Params, obs, xp=np):
    """(logits, value); ``xp`` picks the numpy (rollout) or torch
    (learner) path. Strides are static architecture (NATURE_CONVS), not
    params."""
    if xp is np:
        return _conv_forward_np(params, obs)
    return _conv_forward_torch(params, obs)


def init_conv_params(spec, seed: int) -> Params:
    rng = np.random.default_rng(seed)
    H, W, C = spec.obs_shape

    def dense(fan_in, fan_out, scale=None):
        return dense_init(rng, fan_in, fan_out, scale)

    convs = []
    c_in, h, w = C, H, W
    for c_out, k, stride in NATURE_CONVS:
        fan_in = k * k * c_in
        convs.append({
            "w": (rng.standard_normal((k, k, c_in, c_out))
                  * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "b": np.zeros((c_out,), np.float32),
        })
        h = (h - k) // stride + 1
        w = (w - k) // stride + 1
        c_in = c_out
    flat = h * w * c_in
    torso_width = spec.hidden[0] if spec.hidden else 512
    return {
        "convs": convs,
        "torso": dense(flat, torso_width),
        "logits": dense(torso_width, spec.num_actions, scale=0.01),
        "value": dense(torso_width, 1, scale=1.0),
    }


class ConvModule:
    """Categorical-action CNN module (Atari-class image tasks)."""

    def __init__(self, spec, seed: int = 0):
        if len(spec.obs_shape) != 3:
            raise ValueError(
                f"ConvModule needs obs_shape=(H, W, C), got "
                f"{spec.obs_shape}")
        self.spec = spec
        self.params = init_conv_params(spec, seed)

    def forward_exploration(self, obs: np.ndarray,
                            rng: np.random.Generator):
        logits, value = conv_forward(self.params, obs, np)
        actions, logp = sample_categorical(logits, rng)
        return actions, logp, value

    def forward_inference(self, obs: np.ndarray):
        logits, _ = conv_forward(self.params, obs, np)
        return logits.argmax(-1)

    def forward_values(self, obs: np.ndarray) -> np.ndarray:
        _, value = conv_forward(self.params, obs, np)
        return value

    def get_weights(self) -> Params:
        return self.params

    def set_weights(self, params: Params):
        self.params = params
