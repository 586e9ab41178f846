"""ResNet in PyTorch: the port of ``ray_tpu/models/resnet.py``.

Same model, same arithmetic and the same parameter tree as the JAX
reference, so the two can be held against each other on the same
weights:

- images enter NHWC (``[B, H, W, 3]``) and the conv weights stay HWIO
  arrays, the reference's layouts. Inside, an activation is the NCHW
  view of its NHWC storage (``permute``, no copy), which is PyTorch's
  channels-last memory format: cuDNN runs its NHWC convolutions on it.
  The weights are permuted to OIHW views for ``F.conv2d``;
- ``padding="SAME"`` is XLA's: ``total = max((out - 1) * stride + k -
  in, 0)``, ``total // 2`` before and the rest after. Where that is
  asymmetric (the 7x7 stride-2 stem on 224 pads (2, 3), every 3x3
  stride-2 conv and the 3x3 stride-2 max-pool (0, 1)) the input is
  padded explicitly, the pool with ``-inf``; a symmetric ``padding=``
  argument would shift every output by one pixel;
- convolutions run in ``cfg.dtype`` (f32 accumulation on the card);
  batch norm keeps f32 statistics and casts its output to ``cfg.dtype``
  once; the training statistics are the population variance (ddof 0)
  for both the output and the running update, with
  ``cfg.bn_momentum`` the weight of the OLD value (``nn.BatchNorm2d``
  takes the unbiased variance for its running update and the other
  weight, so it is not used);
- ``forward(train=True)`` returns ``(logits, new_params)`` with the
  updated running statistics, functionally: ``params`` is not touched.

No TPU kernel is on this path: the reference's convolutions are
``lax.conv_general_dilated``, so the port's are cuDNN's through
``F.conv2d``. ``torch.backends.cudnn.allow_tf32`` (PyTorch's default
True) lets f32 convolutions run in TF32 on the card; this module leaves
the flag to the caller.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._private import prng
from .._private.device import DeviceLike, resolve_device

Params = Dict[str, Any]

#: Blocks per stage (torchvision's resnet18/50/101).
DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 18: (2, 2, 2, 2)}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @property
    def stages(self) -> Tuple[int, ...]:
        return DEPTHS[self.depth]

    @property
    def bottleneck(self) -> bool:
        return self.depth >= 50

    def num_params(self) -> int:
        """Every leaf's element count, from the shapes alone."""
        total = 0
        for _, kind, shape in _layout(self):
            total += 4 * shape[0] if kind == "bn" else math.prod(shape)
            if kind == "head":
                total += shape[1]                 # its bias
        return total


def _layout(cfg: ResNetConfig) -> Iterator[Tuple[Tuple, str, Tuple]]:
    """Every leaf group in the reference's draw order (``resnet.py:66-107``):
    ``(path, kind, shape)``, kind ``conv`` (an HWIO kernel, one key),
    ``bn`` (``shape = (c,)``: scale, bias, mean, var) or ``head`` (the
    kernel, one key, and its bias)."""
    yield ("stem", "conv"), "conv", (7, 7, 3, cfg.width)
    yield ("stem", "bn"), "bn", (cfg.width,)
    cin = cfg.width
    expansion = 4 if cfg.bottleneck else 1
    for stage, blocks in enumerate(cfg.stages):
        cmid = cfg.width * (2 ** stage)
        cout = cmid * expansion
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            at = (f"stage{stage}", b)
            if cfg.bottleneck:
                convs = [("conv1", 1, cin, cmid), ("conv2", 3, cmid, cmid),
                         ("conv3", 1, cmid, cout)]
            else:
                convs = [("conv1", 3, cin, cmid), ("conv2", 3, cmid, cout)]
            for i, (name, k, ci, co) in enumerate(convs, 1):
                yield at + (name,), "conv", (k, k, ci, co)
                yield at + (f"bn{i}",), "bn", (co,)
            if cin != cout or stride != 1:
                yield at + ("proj",), "conv", (1, 1, cin, cout)
                yield at + ("proj_bn",), "bn", (cout,)
            cin = cout
    yield ("head",), "head", (cin, cfg.num_classes)


def _bn_init(c: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones(c, dtype=dtype, device=device),
            "bias": torch.zeros(c, dtype=dtype, device=device),
            "mean": torch.zeros(c, dtype=dtype, device=device),
            "var": torch.ones(c, dtype=dtype, device=device)}


def _conv_init(key: torch.Tensor, kh: int, kw: int, cin: int, cout: int,
               dtype: torch.dtype) -> torch.Tensor:
    """He-normal HWIO kernel: ``normal * sqrt(2 / fan_in)`` in f32, the
    scale rounded to f32 first (a weakly typed constant in JAX)."""
    scale = float(np.float32(math.sqrt(2.0 / (kh * kw * cin))))
    return (prng.normal(key, (kh, kw, cin, cout)) * scale).to(dtype)


def _put(tree: Params, path: Tuple, value) -> None:
    """``tree[path[0]][path[1]]... = value``, making the dicts and the
    block lists (an int key) on the way."""
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            node.extend({} for _ in range(k + 1 - len(node)))
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def init_params(cfg: ResNetConfig, key=0, device: DeviceLike = None
                ) -> Params:
    """The reference's weights for ``jax.random.PRNGKey(key)`` (an int
    seed) or for ``key`` itself (a threefry key, ``[2]`` uint32 values),
    bit for bit (``resnet.py:66-107``): one ``split(key, 256)``, each
    conv kernel and then the head kernel drawn from the next key in
    order, on ``device`` (default the card). The tree is the
    reference's: ``stem``, ``stage0..3`` (lists of blocks) and
    ``head``, leaves in ``cfg.param_dtype``."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    if isinstance(key, int):
        key = prng.PRNGKey(key)
    root = torch.as_tensor(np.asarray(key).astype(np.int64), device=dev)
    keys = iter(prng.split(root, 256))
    params: Params = {}
    for path, kind, shape in _layout(cfg):
        if kind == "conv":
            _put(params, path, _conv_init(next(keys), *shape, pd))
        elif kind == "bn":
            _put(params, path, _bn_init(shape[0], pd, dev))
        else:
            k = float(np.float32(0.01))
            params["head"] = {
                "kernel": (prng.normal(next(keys), shape) * k).to(pd),
                "bias": torch.zeros(shape[1], dtype=pd, device=dev)}
    return params


def _map(fn: Callable, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree, device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32) -> Params:
    """The reference's params pytree (leaves already numpy arrays) →
    the same tree of tensors on ``device`` (default the card)."""
    dev = resolve_device(device)
    return _map(lambda x: torch.from_numpy(np.array(x, np.float32)).to(
        device=dev, dtype=dtype), tree)


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, cfg: ResNetConfig
          ) -> torch.Tensor:
    """SAME convolution of ``x [B, C, H, W]`` (channels-last storage) by
    the HWIO kernel ``w``, operands in ``cfg.dtype``."""
    kh, kw = w.shape[:2]
    (t, b), (lft, r) = (_same(x.shape[2], kh, stride),
                        _same(x.shape[3], kw, stride))
    x = x.to(cfg.dtype)
    if t == b and lft == r:
        pad = (t, lft)
    else:
        x, pad = F.pad(x, (lft, r, t, b)), 0
    return F.conv2d(x, w.to(cfg.dtype).permute(3, 2, 0, 1), stride=stride,
                    padding=pad)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _bn_inference(x: torch.Tensor, bn: Params, cfg: ResNetConfig
                  ) -> torch.Tensor:
    """Running statistics folded into an f32 scale and shift
    (``resnet.py:122-128``), the output cast to ``cfg.dtype``."""
    inv = bn["scale"].float() * torch.rsqrt(bn["var"].float() + cfg.bn_eps)
    shift = bn["bias"].float() - bn["mean"].float() * inv
    return (x.float() * _per_channel(inv) + _per_channel(shift)).to(
        cfg.dtype)


def _bn_train(x: torch.Tensor, bn: Params, cfg: ResNetConfig
              ) -> Tuple[torch.Tensor, Params]:
    """Batch statistics in f32 (``resnet.py:131-145``) → (y, the updated
    ``bn``): the population variance, running values ``m * old + (1 -
    m) * batch`` with ``m = cfg.bn_momentum``."""
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = xf.var((0, 2, 3), correction=0)
    inv = bn["scale"].float() * torch.rsqrt(var + cfg.bn_eps)
    y = ((xf - _per_channel(mean)) * _per_channel(inv)
         + _per_channel(bn["bias"].float())).to(cfg.dtype)
    m = cfg.bn_momentum
    new = dict(bn)
    with torch.no_grad():
        new["mean"] = (m * bn["mean"].float() + (1 - m) * mean).to(
            bn["mean"].dtype)
        new["var"] = (m * bn["var"].float() + (1 - m) * var).to(
            bn["var"].dtype)
    return y, new


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max-pool, SAME with ``-inf`` padding
    (``resnet.py:167-168``)."""
    t, b = _same(x.shape[2], 3, 2)
    lft, r = _same(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (lft, r, t, b), value=-math.inf), 3, 2)


def forward(params: Params, x, cfg: ResNetConfig, train: bool = False):
    """images ``[B, H, W, 3]`` float → logits ``[B, num_classes]`` f32
    (``resnet.py:148``). ``train=True`` returns ``(logits, new_params)``:
    the batch statistics normalise, and ``new_params`` is ``params``
    with every batch norm's running ``mean``/``var`` updated (a new
    tree; ``params`` is not touched)."""
    dev = params["head"]["kernel"].device
    x = torch.as_tensor(x, device=dev).permute(0, 3, 1, 2)
    new_params = _map(lambda a: a, params) if train else None

    def bn(h, p, path):
        if not train:
            return _bn_inference(h, p, cfg)
        y, nb = _bn_train(h, p, cfg)
        _put(new_params, path, nb)
        return y

    x = _conv(x, params["stem"]["conv"], 2, cfg)
    x = _max_pool(F.relu(bn(x, params["stem"]["bn"], ("stem", "bn"))))
    for stage in range(len(cfg.stages)):
        for i, blk in enumerate(params[f"stage{stage}"]):
            stride = 2 if (stage > 0 and i == 0) else 1
            path = (f"stage{stage}", i)
            shortcut = x
            if "proj" in blk:
                shortcut = bn(_conv(x, blk["proj"], stride, cfg),
                              blk["proj_bn"], path + ("proj_bn",))
            if cfg.bottleneck:
                h = F.relu(bn(_conv(x, blk["conv1"], 1, cfg), blk["bn1"],
                              path + ("bn1",)))
                h = F.relu(bn(_conv(h, blk["conv2"], stride, cfg),
                              blk["bn2"], path + ("bn2",)))
                h = bn(_conv(h, blk["conv3"], 1, cfg), blk["bn3"],
                       path + ("bn3",))
            else:
                h = F.relu(bn(_conv(x, blk["conv1"], stride, cfg),
                              blk["bn1"], path + ("bn1",)))
                h = bn(_conv(h, blk["conv2"], 1, cfg), blk["bn2"],
                       path + ("bn2",))
            x = F.relu(h + shortcut)
    x = x.float().mean((2, 3))                    # global average pool
    logits = x @ params["head"]["kernel"].float() + \
        params["head"]["bias"].float()
    return (logits, new_params) if train else logits


def make_predictor(cfg: ResNetConfig, params: Params,
                   uint8_input: bool = False) -> Callable:
    """Inference function for serving (``resnet.py:196``): ``predict(
    images)`` → f32 logits, without autograd. ``uint8_input=True`` takes
    raw ``[0, 255]`` uint8 images and normalises them on the device: cast
    to ``cfg.dtype`` and multiplied by ``1/255`` rounded to ``cfg.dtype``,
    as the reference does (a quarter of the float bytes to copy in)."""
    dev = params["head"]["kernel"].device
    scale = torch.tensor(1.0 / 255.0, dtype=cfg.dtype, device=dev)

    @torch.inference_mode()
    def predict(images):
        images = torch.as_tensor(images, device=dev)
        if uint8_input:
            images = images.to(cfg.dtype) * scale
        return forward(params, images, cfg, train=False)

    return predict


def leaves(tree) -> List[torch.Tensor]:
    """The tree's tensors in order (dict keys as inserted, lists in
    order)."""
    out: List[torch.Tensor] = []
    _map(out.append, tree)
    return out
