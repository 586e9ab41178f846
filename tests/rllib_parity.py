"""Measures shared by the rllib parity tests (``test_torch_rllib*.py``).

f32 throughout: gradients sum in another order in each framework and
XLA fuses multiply-adds the port rounds twice, so after updates a
parameter or Adam moment parts from the reference's by an ulp or two a
step (the largest measured, 3.7e-6, was a moment whose terms cancel).
"""
import jax
import numpy as np
import optax

#: Every parameter, target and Adam-moment leaf after updates, relative
#: to max(the leaf's largest magnitude, 1e-3).
STATE_RTOL = 1e-5
#: Every metric, relative to max(|value|, 1).
METRIC_RTOL = 1e-5


def tree_err(got, want) -> float:
    """The largest leaf difference of two trees, each relative to
    max(the leaf's largest |value| in ``want``, 1e-3); shapes and dtypes
    must match and integer leaves must be equal."""
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    worst = 0.0
    for a, b in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (a.shape, a.dtype, b.shape, b.dtype)
        if b.dtype.kind in "iu":
            assert np.array_equal(a, b), (a, b)
            continue
        worst = max(worst, float(np.abs(a.astype(np.float64) - b).max()
                                 / max(float(np.abs(b).max()), 1e-3)))
    return worst


def metric_err(got: dict, want: dict) -> float:
    """The largest difference over ``want``'s keys (arrays elementwise),
    relative to max(|value|, 1)."""
    return max(float(np.max(np.abs(np.asarray(got[k], np.float64) - want[k])
                            / np.maximum(np.abs(want[k]), 1.0)))
               for k in want)


def adam_state(opt_state) -> dict:
    """The ``ScaleByAdamState`` inside an optax chain's state, in the
    port's layout: ``{"count", "mu", "nu"}``."""
    found = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return {"count": np.asarray(found[0].count), "mu": found[0].mu,
            "nu": found[0].nu}


def with_adam_state(opt_state, state: dict):
    """An optax chain's state with its ``ScaleByAdamState`` fields set
    from a state in the port's layout."""
    def swap(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(count=np.asarray(state["count"]),
                              mu=state["mu"], nu=state["nu"])
        return s

    return jax.tree.map(swap, opt_state, is_leaf=lambda x: isinstance(
        x, optax.ScaleByAdamState))


def ref_state(state: dict) -> dict:
    """A reference PPO learner's ``get_state()`` in the port's layout."""
    return {"params": state["params"],
            "opt_state": adam_state(state["opt_state"])}
