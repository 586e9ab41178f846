"""Multislice data parallelism (``ray_tpu_torch.parallel.multislice``) on
CPU rank processes over gloo against the reference's arithmetic.

``dcn_allreduce_tree`` averages a mixed-dtype tree exactly (values
whose mean every dtype holds), each leaf back in its shape and dtype. A
2 x 2 dryrun (two slices of two ranks, ``{dp: 2}`` inside each) gives
every slice's loss and the common checksum of the reference's
``slice_main`` (``ray_tpu/parallel/multislice.py:55-125``), computed here
in-process with JAX from the same weights (``init_params`` of the
reference's key 0) and tokens (``default_rng(1000 + slice)``), without
the reference's runtime; nano computes in bf16 in both, so they are
held within ``LOSS_TOL`` / ``CHECKSUM_TOL``. ``run_multislice_dryrun``
itself runs two slices of one rank.
"""
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

#: bf16 forward/backward of the two packages on the same weights and
#: tokens: the losses part at the bf16 rounding (3.9e-5 seen here).
LOSS_TOL = 2e-4
#: Relative: the checksum sums ~110k updated weights, lr 0.1 times the
#: bf16 gradients' rounding differences (3.2e-6 seen here).
CHECKSUM_TOL = 2e-5


def _rank_tree(n):
    """This rank's mixed-dtype tree averaged over the world."""
    import torch.distributed as dist

    from ray_tpu_torch.collective.collective import (MeshGroup,
                                                     new_process_group)
    from ray_tpu_torch.parallel import dcn_allreduce_tree

    r = dist.get_rank()
    group = MeshGroup("world", new_process_group(range(n)), list(range(n)),
                      torch.device("cpu"))
    tree = {"a": torch.full((2, 3), 4.0 * r),
            "b": [torch.arange(6, dtype=torch.bfloat16).view(3, 2) * (r + 1),
                  np.full((4,), 8 * r, np.int32)],
            "c": {"d": torch.tensor(2.0 * r, dtype=torch.float16)}}
    out = dcn_allreduce_tree(tree, group)
    return {"a": out["a"], "b0": out["b"][0], "b1": out["b"][1],
            "d": out["c"]["d"]}


def _rank_slice(n_slices, per_slice):
    from ray_tpu_torch.parallel.multislice import slice_rank

    return slice_rank(n_slices, per_slice, "cpu")


@pytest.fixture(scope="module")
def pool4():
    from ray_tpu_torch._private.ranks import RankPool

    with RankPool(4, devices=("cpu",) * 4) as pool:
        yield pool


def test_dcn_allreduce_tree_mixed_dtypes(pool4):
    n = 4
    mean_r = sum(range(n)) / n                     # 1.5
    for out in pool4.run(_rank_tree, n):
        assert out["a"].dtype == torch.float32 and out["a"].shape == (2, 3)
        assert torch.equal(out["a"], torch.full((2, 3), 4.0 * mean_r))
        assert out["b0"].dtype == torch.bfloat16
        assert torch.equal(out["b0"], torch.arange(
            6, dtype=torch.bfloat16).view(3, 2) * (mean_r + 1))
        assert out["b1"].dtype == np.int32 and out["b1"].shape == (4,)
        np.testing.assert_array_equal(out["b1"], np.full(4, 12, np.int32))
        assert out["d"].dtype == torch.float16 and out["d"].shape == ()
        assert out["d"].item() == 2.0 * mean_r


def _reference(n_slices):
    """The reference's slice_main arithmetic in-process: every slice's
    loss and the checksum of the averaged SGD update."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt

    cfg = jgpt.CONFIGS["nano"]
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)

    def loss_fn(params, tokens):
        logits = jgpt.forward(params, tokens[:, :-1], cfg)
        logp = jax.nn.log_softmax(logits, axis=-1)
        ll = jnp.take_along_axis(logp, tokens[:, 1:][..., None],
                                 axis=-1)[..., 0]
        return -jnp.mean(ll)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses, grads = [], []
    for s in range(n_slices):
        tokens = np.random.default_rng(1000 + s).integers(
            0, cfg.vocab_size, (8, 33)).astype(np.int32)
        loss, g = grad_fn(params, jnp.asarray(tokens))
        losses.append(float(loss))
        grads.append(jax.device_get(g))
    avg = jax.tree.map(lambda *g: sum(np.asarray(x, np.float32) for x in g)
                       / n_slices, *grads)
    new = jax.tree.map(lambda p, g: np.asarray(p, np.float32) - 0.1 * g,
                       params, avg)
    checksum = float(sum(float(np.sum(l)) for l in jax.tree.leaves(new)))
    return losses, checksum


def test_dryrun_matches_reference(pool4):
    reports = pool4.run(_rank_slice, 2, 2)
    assert [r["slice"] for r in reports] == [0, 0, 1, 1]
    assert all(r["agree"] for r in reports), reports
    assert len({r["checksum"] for r in reports}) == 1, reports
    losses, checksum = _reference(2)
    for r in reports:
        assert abs(r["loss"] - losses[r["slice"]]) <= LOSS_TOL, (r, losses)
        assert abs(r["checksum"] - checksum) <= CHECKSUM_TOL * abs(
            checksum), (r, checksum)


def test_run_multislice_dryrun_entry_point():
    from ray_tpu_torch.parallel import run_multislice_dryrun

    rep = run_multislice_dryrun(2, 1, device="cpu")
    assert [r["slice"] for r in rep["slices"]] == [0, 1]
    assert all(r["agree"] for r in rep["slices"])
    assert len({r["checksum"] for r in rep["slices"]}) == 1
