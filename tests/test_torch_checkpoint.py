"""Checkpoints and the train session (``ray_tpu_torch.train``) against the
reference's (``ray_tpu.train``).

The npz format is shared: a params checkpoint the reference writes loads
into the port's flat parameter dict bit for bit, and one the port writes
loads into the reference's pytree; other trees flatten in
``jax.tree_util``'s order. ``CheckpointManager`` keeps and deletes the
same checkpoints as the reference's for the same reports. Sharded
checkpoints (``torch.distributed.checkpoint``) on two CPU rank
processes: saved at ``{fsdp:2}`` and loaded at ``{tp:2}``, and saved by
one process and loaded at ``{fsdp:2}``, the gathered parameters are
bit-equal.

JAX is imported inside the tests: the rank processes import this module
to find their functions and need only torch.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.train import checkpoint as tck
from ray_tpu_torch.train import session as tsess
from torch_threads import one_torch_thread  # noqa: F401


def _jax_params(moe: bool):
    import jax

    from ray_tpu.models import gpt as jgpt

    cfg = dataclasses.replace(jgpt.CONFIGS["nano"],
                              n_experts=4 if moe else 0)
    return jgpt.init_params(jax.random.PRNGKey(7), cfg)


def _flat_np(tree):
    import jax

    return tgpt.params_flat(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_reference_npz_loads_into_port(tmp_path, moe):
    from ray_tpu.train import Checkpoint as JCheckpoint

    jparams = _jax_params(moe)
    path = JCheckpoint.from_state(jparams, base_dir=str(tmp_path)).path
    like = {k: torch.zeros(v.shape) for k, v in _flat_np(jparams).items()}
    got = tck.Checkpoint(path).load_state(like=like)
    assert list(got) == list(like)
    for k, v in _flat_np(jparams).items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_port_npz_loads_into_reference(tmp_path, moe):
    import jax

    from ray_tpu.train import Checkpoint as JCheckpoint

    jparams = _jax_params(moe)
    port = {k: torch.from_numpy(np.array(v)) for k, v in
            _flat_np(jparams).items()}
    ck = tck.Checkpoint.from_state(port, base_dir=str(tmp_path))
    got = JCheckpoint(ck.path).load_state(like=jparams)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # bf16 tensors are stored as f32, exactly, and come back as bf16.
    half = {k: v.to(torch.bfloat16) for k, v in port.items()}
    back = tck.Checkpoint.from_state(half, base_dir=str(tmp_path)) \
        .load_state(like=half)
    assert all(torch.equal(back[k], half[k]) for k in half)


def test_npz_leaf_order_matches_reference(tmp_path):
    """A nested tree of dicts (inserted unsorted), lists and a None
    flattens as ``jax.tree_util`` does, in both directions."""
    from ray_tpu.train import Checkpoint as JCheckpoint

    rng = np.random.default_rng(0)
    tree = {"zeta": [rng.standard_normal(3), None, rng.standard_normal(2)],
            "alpha": {"b": rng.standard_normal((2, 2)),
                      "a": np.arange(4)}, "mid": rng.standard_normal(1)}
    mine = tck.Checkpoint.from_state(tree, base_dir=str(tmp_path))
    ref = JCheckpoint.from_state(tree, base_dir=str(tmp_path))
    a = mine.load_state()
    b = tck.Checkpoint(ref.path).load_state()
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    back = mine.load_state(like=tree)
    assert back["zeta"][1] is None
    np.testing.assert_array_equal(back["alpha"]["a"], tree["alpha"]["a"])
    with open(os.path.join(mine.path, "meta.json")) as f:
        assert '"n_leaves": 5' in f.read()


def test_checkpoint_manager_matches_reference(tmp_path):
    """The same reports keep (and delete) the same checkpoints: top 2 by
    a min-ordered loss, the latest never deleted, a missing metric
    ranked worst."""
    from ray_tpu.train import checkpoint as jck

    losses = [5.0, 3.0, None, 4.0, 6.0, 1.0, 2.5]
    kept = []
    for mod in (tck, jck):
        root = tmp_path / mod.__name__.split(".")[0]
        mgr = mod.CheckpointManager(str(root / "store"), num_to_keep=2,
                                    score_attribute="loss",
                                    score_order="min")
        dirs = []
        for i, loss in enumerate(losses):
            d = root / f"ck{i}"
            d.mkdir(parents=True)
            dirs.append(str(d))
            mgr.register(mod.Checkpoint(str(d)),
                         {} if loss is None else {"loss": loss})
        kept.append(([dirs.index(c.path) for c in mgr.checkpoints],
                     dirs.index(mgr.best_checkpoint.path),
                     dirs.index(mgr.latest_checkpoint.path),
                     [os.path.exists(d) for d in dirs]))
    assert kept[0] == kept[1]
    assert kept[0][0] == [5, 6] and kept[0][1] == 5


def test_session(tmp_path):
    """report moves a checkpoint into storage under a rank- and
    incarnation-stamped name; the session's sharded paths carry the rank
    in a single process; the context reads the session; a storage URI is
    a checkpoint path."""
    with pytest.raises(RuntimeError, match="No train session"):
        tsess.report({"loss": 1.0})
    store = tmp_path / "store"
    s = tsess.init_session(world_rank=0, world_size=1, storage_dir=str(store),
                           experiment_name="exp", incarnation=2)
    try:
        ck = tck.Checkpoint.from_state({"w": np.ones(2)},
                                       base_dir=str(tmp_path))
        tsess.report({"loss": 1.0}, checkpoint=ck)
        got = tsess.get_checkpoint()
        assert got.path == str(store / "checkpoint_rank0_i2_000000")
        assert os.path.exists(got.path) and not os.path.exists(ck.path)
        msg = s.result_queue.get_nowait()
        assert msg["metrics"] == {"loss": 1.0} and msg["rank"] == 0
        assert msg["checkpoint"] == {"path": got.path}
        assert s.next_sharded_checkpoint_path() == \
            str(store / "sharded_rank0_i2_000000")
        ctx = tsess.get_context()
        assert (ctx.get_world_rank(), ctx.get_world_size(),
                ctx.get_experiment_name()) == (0, 1, "exp")
        with pytest.raises(KeyError):
            tsess.get_dataset_shard("train")
    finally:
        tsess.shutdown_session()
    # a storage URI stays a URI (train/storage.py); a cloud scheme is
    # refused when the checkpoint is read
    assert tck.Checkpoint("mock://bucket/x").path == "mock://bucket/x"
    with pytest.raises(ValueError, match="cloud storage scheme"):
        tck.Checkpoint("gs://bucket/x").as_directory()


# --------------------------------------------------- sharded, two ranks
@pytest.fixture(scope="module")
def pool2():
    from ray_tpu_torch._private.ranks import RankPool

    with RankPool(2, devices=("cpu",) * 2) as pool:
        yield pool


def _cfg():
    return dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)


def _rank_sharded(path, axes, save, seed):
    """Save this mesh's shards of a seeded state (``save``) or load them
    into one drawn from another seed; rank 0 returns the gathered
    parameters."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import gather_tree

    mesh = tmesh.create_mesh(axes, device="cpu")
    init, step, places, _ = tgpt.make_train_step(_cfg(), mesh)
    state = init(seed=seed)
    if save:
        state, _ = step(state, {"tokens": torch.arange(4 * 17).reshape(
            4, 17) % 512})
        try:
            tck.Checkpoint.from_sharded_state(state["params"],
                                              placements=places["params"])
        except ValueError as e:
            refused = str(e)
        tck.Checkpoint.from_sharded_state(state["params"], path=path,
                                          placements=places["params"])
    else:
        refused = None
        state["params"] = tck.Checkpoint(path).load_sharded_state(
            state["params"], placements=places["params"])
    full = gather_tree(state["params"], places["params"])
    if dist.get_rank():
        return None
    return refused, {k: v.detach().numpy() for k, v in full.items()}


def test_sharded_checkpoint_reshards(pool2, tmp_path):
    path = str(tmp_path / "ck")
    refused, saved = pool2.run(_rank_sharded, path, {"fsdp": 2}, True, 0)[0]
    assert "explicit `path`" in refused
    _, loaded = pool2.run(_rank_sharded, path, {"tp": 2}, False, 1)[0]
    assert set(saved) == set(loaded)
    for k in saved:
        np.testing.assert_array_equal(loaded[k], saved[k], err_msg=k)
    assert os.path.exists(os.path.join(path, "sharded", ".metadata"))


def test_one_process_checkpoint_loads_sharded(pool2, tmp_path):
    """Saved by one process (no process group), loaded at {fsdp:2}; and
    loaded back by one process."""
    mesh = tmesh.single_device_mesh(device="cpu")
    init, _, places, _ = tgpt.make_train_step(_cfg(), mesh)
    state = init(seed=3)
    ck = tck.Checkpoint.from_sharded_state(state["params"],
                                           base_dir=str(tmp_path),
                                           placements=places["params"])
    _, loaded = pool2.run(_rank_sharded, ck.path, {"fsdp": 2}, False, 1)[0]
    back = ck.load_sharded_state(init(seed=1)["params"],
                                 placements=places["params"])
    for k, v in state["params"].items():
        np.testing.assert_array_equal(loaded[k], v.detach().numpy())
        assert torch.equal(back[k], v.detach())
