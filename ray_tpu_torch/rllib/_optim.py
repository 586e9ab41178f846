"""The optax pieces the reference's learners use, as optax computes them.

``optax.chain(optax.clip_by_global_norm(c), optax.adam(lr))`` (PPO, DQN,
SAC/CQL) and ``optax.adam(lr)`` (BC, MARWIL), with optax's defaults
(b1 0.9, b2 0.999, eps 1e-8, eps_root 0), on a parameter tree of
tensors:

- the global norm is ``sqrt`` of the sum, leaf by leaf in
  ``jax.tree_util`` order, of each leaf's ``sum(g * g)``; past
  ``max_norm`` each gradient becomes ``(g / norm) * max_norm``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` and is
  another function);
- Adam updates ``mu = (1 - b1) g + b1 mu`` and ``nu = (1 - b2) g² + b2
  nu``, counts in int32 (saturating, as ``numerics.safe_increment``),
  divides each moment by its own bias correction ``1 - b**count`` (f32)
  and steps ``p + (-lr) * mu_hat / (sqrt(nu_hat) + eps)``
  (``torch.optim.Adam`` orders these roundings otherwise).

The state is ``{"count": int32 [], "mu": tree, "nu": tree}``, the fields
of optax's ``ScaleByAdamState``; as numpy leaves
(:func:`~ray_tpu_torch.rllib.rl_module.params_to_numpy`) it maps onto
that state and back. Clipping and the learning-rate scale keep no state.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .._private import tree

_INT32_MAX = 2 ** 31 - 1


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm`` over the leaves in order."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm(max_norm)``'s update, without a host
    read of the norm."""
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]


class Adam:
    """``optax.adam(lr)``, behind ``optax.clip_by_global_norm(grad_clip)``
    when ``grad_clip`` is given."""

    def __init__(self, lr: float, *, grad_clip: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.grad_clip = lr, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> Dict[str, Any]:
        leaf = tree.leaves(params)[0]
        zeros = tree.map_with_path(lambda _, p: torch.zeros_like(p), params)
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                "mu": zeros,
                "nu": tree.map_with_path(lambda _, p: torch.zeros_like(p),
                                         params)}

    @torch.no_grad()
    def update(self, params, grads, state) -> Tuple[Any, Dict[str, Any]]:
        """One step: ``(new params, new state)`` (new tensors; nothing is
        written in place)."""
        b1, b2 = self.b1, self.b2
        g = tree.leaves(grads)
        if self.grad_clip is not None:
            g = clip_by_global_norm(g, self.grad_clip)
        mu = [(1 - b1) * gi + b1 * m
              for gi, m in zip(g, tree.leaves(state["mu"]))]
        nu = [(1 - b2) * (gi * gi) + b2 * v
              for gi, v in zip(g, tree.leaves(state["nu"]))]
        count = state["count"]
        count = torch.where(count < _INT32_MAX, count + 1, count)
        bc1 = 1 - torch.pow(b1, count)
        bc2 = 1 - torch.pow(b2, count)
        new = [p + (-self.lr) * ((m / bc1) / (torch.sqrt(v / bc2)
                                              + self.eps))
               for p, m, v in zip(tree.leaves(params), mu, nu)]
        return tree.unflatten(params, new), {
            "count": count, "mu": tree.unflatten(params, mu),
            "nu": tree.unflatten(params, nu)}


def value_and_grad(loss_fn: Callable, params, *args):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``:
    ``((loss, aux), grads)`` with ``grads`` shaped as ``params`` (zeros
    for a leaf the loss does not reach, as JAX gives)."""
    leaves = tree.leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, aux = loss_fn(tree.unflatten(params, live), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
           for k, v in aux.items()}
    return (loss.detach(), aux), tree.unflatten(params, list(grads))
