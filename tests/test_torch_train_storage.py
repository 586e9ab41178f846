"""Checkpoint storage and sharded-checkpoint fault tolerance in the port
(``ray_tpu_torch.train``: ``storage.py``, URI checkpoints, the session's
derived sharded paths, the group restart).

The counterparts of ``test_storage_restore.py`` (``mock://`` resolution
through both packages, a URI round trip, retention in storage, a trainer
on shared storage; the Tuner restore waits for Tune, ROADMAP Queue 1
item 5) and of ``test_train_sharded_ft.py``, including the gang restart
after a worker is killed with ``kill -9``: the gang resumes from its
latest sharded checkpoint with no path anywhere in the loop.
"""
import os
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.train import session as tsess
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.storage import get_filesystem, is_uri
from torch_runtime import case_time_limit, rt_port  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CASE_LIMIT_S = 120.0


@pytest.fixture
def mock_root(tmp_path, monkeypatch):
    monkeypatch.setenv("RT_MOCK_FS_ROOT", str(tmp_path / "bucket"))
    return str(tmp_path / "bucket")


@pytest.mark.parametrize("path", ["mock://exp/ckpt", "/tmp/x",
                                  "file:///tmp/y", "gs://bucket/x",
                                  "s3://b/k", "hdfs://h/p"])
def test_filesystem_resolution_matches_reference(mock_root, path):
    """Both packages resolve a storage path to the same place, or refuse
    it with the same message."""
    from ray_tpu.train import storage as ref

    def resolve(mod):
        try:
            fs, uri = mod.get_filesystem(path)
        except ValueError as e:
            return ("refused", str(e))
        return (type(fs).__name__, fs.resolve(uri), mod.is_uri(path))

    got = resolve(__import__("ray_tpu_torch.train.storage",
                             fromlist=["x"]))
    assert got == resolve(ref)
    if path == "mock://exp/ckpt":
        assert got[1] == os.path.join(mock_root, "exp/ckpt")
    if path.startswith("gs://"):
        assert got[0] == "refused" and "cloud" in got[1]


def test_checkpoint_uri_roundtrip(mock_root, tmp_path):
    """A checkpoint uploaded to ``mock://`` loads through its URI (a
    local download), and the reference's reader loads the same URI."""
    from ray_tpu.train.checkpoint import Checkpoint as JCheckpoint

    state = {"w": np.arange(8.0), "b": np.float32(3)}
    local = Checkpoint.from_state(state, base_dir=str(tmp_path))
    fs, _ = get_filesystem("mock://exp1/c0")
    fs.upload_dir(local.path, "mock://exp1/c0")

    remote = Checkpoint("mock://exp1/c0")
    assert is_uri(remote.path) and remote.path == "mock://exp1/c0"
    restored = remote.load_state(like=state)
    np.testing.assert_array_equal(restored["w"], state["w"])
    assert remote.as_directory() != os.path.join(mock_root, "exp1/c0")
    ref = JCheckpoint("mock://exp1/c0").load_state()
    for a, b in zip(ref, remote.load_state()):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_manager_uri_retention(mock_root, tmp_path):
    mgr = CheckpointManager("mock://exp2/ckpts", num_to_keep=2,
                            score_attribute="acc")
    fs, _ = get_filesystem("mock://exp2/ckpts")
    for i, acc in enumerate([0.1, 0.9, 0.5]):
        local = Checkpoint.from_state({"i": np.int64(i)},
                                      base_dir=str(tmp_path))
        uri = f"mock://exp2/ckpts/c{i}"
        fs.upload_dir(local.path, uri)
        mgr.register(Checkpoint(uri), {"acc": acc})
    assert fs.listdir("mock://exp2/ckpts") == ["c1", "c2"]
    assert mgr.best_checkpoint.path.endswith("c1")


def test_trainer_with_shared_storage(rt_port):
    """Workers upload their checkpoints straight to the shared bucket;
    a non-lead rank keeps its two latest there and deletes the rest.

    No environment patch: the workers resolve the default
    ``RT_MOCK_FS_ROOT``, as the driver does."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop(config):
        import numpy as np

        for step in range(4):
            ckpt = Checkpoint.from_state({"step": np.int64(step)})
            train.report({"loss": 1.0 - step * 0.1}, checkpoint=ckpt)

    name = f"shared_{os.getpid()}_{int(time.time() * 1e3)}"
    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name=name, storage_path="mock://results")).fit()
    assert result.error is None
    assert result.checkpoint.path.startswith("mock://results/" + name)
    state = result.checkpoint.load_state(like={"step": np.int64(0)})
    assert int(state["step"]) == 3
    fs, _ = get_filesystem("mock://results")
    kept = fs.listdir(f"mock://results/{name}/checkpoints")
    assert [k for k in kept if k.startswith("checkpoint_rank1_")] == \
        ["checkpoint_rank1_i0_000002", "checkpoint_rank1_i0_000003"]
    assert len([k for k in kept if k.startswith("checkpoint_rank0_")]) == 4
    fs.rmtree(f"mock://results/{name}")


# ------------------------------------------------ test_train_sharded_ft.py
def test_session_derives_deterministic_sharded_path(tmp_path, monkeypatch):
    """Two lockstep sessions derive the same path sequence in one process
    group of two (one collective checkpoint); lone processes carry their
    rank in the name."""
    from ray_tpu_torch.train import session as S

    a = S._TrainSession(world_rank=0, world_size=2,
                        storage_dir=str(tmp_path), incarnation=1)
    b = S._TrainSession(world_rank=1, world_size=2,
                        storage_dir=str(tmp_path), incarnation=1)
    monkeypatch.setattr(S, "_process_count", lambda: 2)
    p0a, p1a = (a.next_sharded_checkpoint_path(),
                a.next_sharded_checkpoint_path())
    p0b, p1b = (b.next_sharded_checkpoint_path(),
                b.next_sharded_checkpoint_path())
    assert p0a == p0b and p1a == p1b and p0a != p1a
    assert p0a == str(tmp_path / "sharded_i1_000000")
    monkeypatch.setattr(S, "_process_count", lambda: 1)
    a2 = S._TrainSession(world_rank=0, world_size=2,
                         storage_dir=str(tmp_path), incarnation=1)
    b2 = S._TrainSession(world_rank=1, world_size=2,
                         storage_dir=str(tmp_path), incarnation=1)
    assert a2.next_sharded_checkpoint_path() != \
        b2.next_sharded_checkpoint_path()


def test_sharded_save_without_path_inside_session(tmp_path, monkeypatch):
    """``from_sharded_state`` with no path (and no placements: every
    leaf whole) lands in the session's derived directory and restores
    through ``get_checkpoint``; a collective directory (several
    processes) stays where every rank wrote it."""
    from ray_tpu_torch.train import session as S

    s = tsess.init_session(world_rank=0, world_size=1,
                           storage_dir=str(tmp_path), incarnation=0)
    try:
        state = {"w": torch.arange(8.0),
                 "step": torch.tensor(3, dtype=torch.int32)}
        ckpt = Checkpoint.from_sharded_state(state)
        assert ckpt.path == str(tmp_path / "sharded_rank0_i0_000000")
        s.report({"loss": 1.0}, checkpoint=ckpt)
        like = {"w": torch.zeros(8),
                "step": torch.tensor(0, dtype=torch.int32)}
        out = s.get_checkpoint().load_sharded_state(like)
        assert torch.equal(out["w"], torch.arange(8.0))
        assert int(out["step"]) == 3 and out["step"].dtype == torch.int32

        ckpt2 = Checkpoint.from_sharded_state(
            {"w": torch.arange(4.0),
             "step": torch.tensor(9, dtype=torch.int32)})
        monkeypatch.setattr(S, "_process_count", lambda: 2)
        s.report({"loss": 0.5}, checkpoint=ckpt2)
        assert s.get_checkpoint().path == ckpt2.path   # left in place
        out2 = s.get_checkpoint().load_sharded_state(
            {"w": torch.zeros(4),
             "step": torch.tensor(0, dtype=torch.int32)})
        assert int(out2["step"]) == 9
    finally:
        tsess.shutdown_session()


def test_gang_restart_resumes_from_sharded_checkpoint(rt_port, tmp_path):
    """A worker process killed with ``kill -9`` mid-run: the gang of two
    restarts and resumes from its latest sharded checkpoint, with no
    path anywhere in the loop (the reference's case fails on its own
    tree, ROADMAP Queue 3 item 5; the port's must pass).

    The gang is one process group (``multi_controller=True``): every
    save is collective, so the ranks keep in step, and a report returns
    once the driver holds it; when one rank dies after its report of
    step 2, both ranks' reports of step 1 are in, and the latest
    checkpoint is step 1's or later. (With independent ranks, as in the
    reference's case, a fast rank can die before a slow one has reported
    anything, and the gang rightly starts over.)"""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchBackendConfig,
                                     TorchTrainer)

    marker = tmp_path / "killed_once"

    def loop(config):
        import os

        import torch
        import torch.distributed as dist

        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            like = {"w": torch.zeros(4),
                    "step": torch.tensor(0, dtype=torch.int32)}
            start = int(ckpt.load_sharded_state(like)["step"]) + 1
        for step in range(start, 5):
            state = {"w": torch.full((4,), float(step)),
                     "step": torch.tensor(step, dtype=torch.int32)}
            c = Checkpoint.from_sharded_state(state)    # no path anywhere
            train.report({"step": step, "resumed_from": start,
                          "world": dist.get_world_size()}, checkpoint=c)
            if step == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").write("x")
                os.kill(os.getpid(), 9)    # a hard kill, not an exception

    r = TorchTrainer(
        loop, train_loop_config={"marker": str(marker)},
        torch_config=TorchBackendConfig(multi_controller=True),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path / "store"),
                             failure_config=FailureConfig(max_failures=2)),
    ).fit()
    assert r.error is None
    assert marker.exists()                    # the kill happened
    last = r.metrics_history[-1]
    assert (last["step"], last["world"]) == (4, 2)
    assert last["resumed_from"] >= 1, [
        (m["step"], m["resumed_from"]) for m in r.metrics_history]
    like = {"w": torch.zeros(4), "step": torch.tensor(0, dtype=torch.int32)}
    out = r.checkpoint.load_sharded_state(like)
    assert int(out["step"]) == 4
    assert torch.equal(out["w"], torch.full((4,), 4.0))
    # one collective directory of the restarted incarnation
    assert os.path.basename(r.checkpoint.path) == "sharded_i1_%06d" % (
        4 - last["resumed_from"])
