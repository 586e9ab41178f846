"""Train on the port's runtime (``ray_tpu_torch.train``: ``TorchTrainer``,
the worker group, the backend executor) against the reference's
(``ray_tpu.train``).

The counterparts of ``test_train.py``'s runtime cases (single and
multi-worker fits, a checkpoint, a restart after an exception, failures
exhausted), then parity: GPT nano trained for 3 steps at f32 through
``TorchTrainer`` on the CPU and through the reference's ``JaxTrainer``
(in a subprocess, on its own runtime) from the same weights on the same
seeded tokens, the loss histories within ``LOSS_TOL``; and two workers
joined into one gloo process group (``multi_controller=True``) training
``{dp:2}``, whose first loss equals one rank's. A ``use_gpu=True`` gang
on a runtime that advertises GPUs but has no card raises.

Every loop is defined inside its test: the workers cannot import
``tests/``, and a local function ships by value.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_runtime import case_time_limit, rt_port  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CASE_LIMIT_S = 120.0
#: GPUs the module's runtime advertises (no card behind them).
RT_NUM_GPUS = 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# f32: the packages differ in summation order only (test_torch_train.py).
LOSS_TOL = 1e-5
NANO_B, NANO_S, NANO_STEPS = 4, 64, 3


def test_fit_single_worker(rt_port, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop(config):
        for step in range(3):
            train.report({"step": step, "loss": 1.0 / (step + 1)})

    r = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=1),
                     run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert r.error is None
    assert [m["step"] for m in r.metrics_history] == [0, 1, 2]
    assert r.metrics["loss"] == pytest.approx(1 / 3)
    assert r.path.startswith(str(tmp_path))


def test_fit_multi_worker_with_checkpoint(rt_port, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.train import (Checkpoint, RunConfig, ScalingConfig,
                                     TorchTrainer)

    def loop(config):
        import numpy as np

        ctx = train.get_context()
        rank, world = ctx.get_world_rank(), ctx.get_world_size()
        assert world == 2
        for step in range(2):
            ckpt = None
            if rank == 0:
                ckpt = Checkpoint.from_state({"step": np.int64(step)})
            train.report({"step": step, "rank": rank}, checkpoint=ckpt)

    r = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=2),
                     run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert r.error is None
    assert len(r.metrics_history) == 2
    assert all(m["rank"] == 0 for m in r.metrics_history)  # rank 0 wins
    assert r.checkpoint is not None
    assert int(r.checkpoint.load_state()[0]) == 1
    assert r.metrics["checkpoint_path"] == r.checkpoint.path


def test_fit_failure_then_restart(rt_port, tmp_path):
    """The loop raises once; the group restarts and resumes from the
    checkpoint of step 1."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import (Checkpoint, FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)

    marker = tmp_path / "crashed_once"

    def loop(config):
        import os

        import numpy as np

        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = int(ckpt.load_state()[0]) + 1
        for step in range(start, 4):
            train.report({"step": step, "start": start},
                         checkpoint=Checkpoint.from_state(np.int64(step)))
            if step == 1 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").write("x")
                raise RuntimeError("injected failure")

    r = TorchTrainer(
        loop, train_loop_config={"marker": str(marker)},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path / "store"),
                             failure_config=FailureConfig(max_failures=2)),
    ).fit()
    assert r.error is None
    assert marker.exists()
    assert [m["step"] for m in r.metrics_history][-2:] == [2, 3]
    assert r.metrics_history[-1]["start"] == 2
    # the restarted incarnation's checkpoints carry its number
    assert "_i1_" in r.checkpoint.path


def test_fit_failure_exhausted(rt_port, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer, TrainingFailedError)

    def loop(config):
        train.report({"step": 0})
        raise RuntimeError("always fails")

    r = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert isinstance(r.error, TrainingFailedError)
    assert "always fails" in str(r.error)
    assert "failure 2 > max_failures=1" in str(r.error)


def test_use_gpu_without_a_card_raises(rt_port, tmp_path):
    """The runtime advertises a GPU, but the worker given it finds no
    CUDA device: ``fit`` raises (nothing falls back to the CPU), and the
    gang's worker and placement group are released."""
    import time

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop():
        raise AssertionError("the loop must not run")

    trainer = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                           gpus_per_worker=1),
        run_config=RunConfig(storage_path=str(tmp_path)))
    with pytest.raises(Exception, match="no CUDA device"):
        trainer.fit()
    deadline = time.time() + 15
    while rt_port.available_resources().get("GPU") != 1.0 and \
            time.time() < deadline:
        time.sleep(0.2)
    assert rt_port.available_resources().get("GPU") == 1.0


def test_as_trainable_names_the_tune_item():
    from ray_tpu_torch.train import TorchTrainer

    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        TorchTrainer(lambda: None).as_trainable()


# ------------------------------------------------------------- parity
def _nano_np_tree():
    """The reference's nano parameters (``make_train_step``'s init from
    key 0 on one device), as numpy."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import create_mesh

    cfg = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
    mesh = create_mesh({"dp": 1}, devices=[jax.devices()[0]])
    jinit, _, _, _ = jgpt.make_train_step(cfg, mesh)
    return jax.tree_util.tree_map(np.array, jinit(jax.random.PRNGKey(0))[
        "params"])


def _tokens():
    return np.random.default_rng(11).integers(
        0, 512, (NANO_B, NANO_S + 1)).astype(np.int32)


REFERENCE_FIT = r'''
import dataclasses, json, sys, tempfile
import numpy as np
import ray_tpu as rt
from ray_tpu import train
from ray_tpu.train import JaxTrainer, RunConfig, ScalingConfig


def loop(config):
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ray_tpu import train
    from ray_tpu.models import gpt
    from ray_tpu.parallel import create_mesh

    cfg = dataclasses.replace(gpt.CONFIGS["nano"], dtype=jnp.float32)
    mesh = create_mesh({"dp": 1}, devices=[jax.devices()[0]])
    init, step, _, _ = gpt.make_train_step(cfg, mesh)
    state = init(jax.random.PRNGKey(0))
    toks = jnp.asarray(np.asarray(config["tokens"], np.int32))
    for i in range(config["steps"]):
        state, m = step(state, {"tokens": toks})
        train.report({"loss": float(m["loss"]), "step": i})


rt.init(num_cpus=2)
tokens, steps = json.loads(sys.stdin.read())
r = JaxTrainer(loop, train_loop_config={"tokens": tokens, "steps": steps},
               scaling_config=ScalingConfig(num_workers=1),
               run_config=RunConfig(storage_path=tempfile.mkdtemp())).fit()
assert r.error is None, r.error
print("LOSSES " + json.dumps([m["loss"] for m in r.metrics_history]))
rt.shutdown()
'''


def _reference_losses(tokens) -> list:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE_FIT],
        input=json.dumps([tokens.tolist(), NANO_STEPS]), env=env,
        capture_output=True, text=True, timeout=110)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("LOSSES ")]
    assert out.returncode == 0 and lines, out.stderr[-3000:]
    return json.loads(lines[0][len("LOSSES "):])


def test_nano_fit_matches_jax_trainer(rt_port, tmp_path):
    """GPT nano, f32, 3 steps through ``TorchTrainer`` on the CPU and
    through the reference's ``JaxTrainer``, from the same weights (the
    reference's draw reaches the port through ``params_from_numpy``) on
    the same tokens: the loss histories agree within LOSS_TOL and fall."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop(config):
        import dataclasses

        import torch

        from ray_tpu_torch.models import gpt

        cfg = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.float32)
        init, step, _, _ = gpt.make_train_step(cfg, device="cpu")
        state = init(params=gpt.params_from_numpy(config["params"], "cpu"))
        batch = {"tokens": torch.from_numpy(config["tokens"])}
        for i in range(config["steps"]):
            state, m = step(state, batch)
            train.report({"loss": m["loss"].item(), "step": i})

    tokens = _tokens()
    r = TorchTrainer(
        loop, train_loop_config={"params": _nano_np_tree(),
                                 "tokens": tokens, "steps": NANO_STEPS},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert r.error is None
    losses = [m["loss"] for m in r.metrics_history]
    want = _reference_losses(tokens)
    assert len(losses) == len(want) == NANO_STEPS
    np.testing.assert_allclose(losses, want, rtol=0, atol=LOSS_TOL)
    assert losses[-1] < losses[0]


def test_multi_controller_dp2_first_loss_equals_one_rank(rt_port, tmp_path):
    """Two workers joined into one gloo process group
    (``multi_controller=True``) train nano at ``{dp:2}``, each on half of
    the global batch: the first loss equals one rank's (the whole batch
    in this process) within LOSS_TOL, both ranks report the same losses,
    and the group's world is the gang."""
    import dataclasses

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                     TorchBackendConfig, TorchTrainer)

    def loop(config):
        import dataclasses

        import torch
        import torch.distributed as dist

        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.parallel import create_mesh

        cfg = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.float32)
        mesh = create_mesh({"dp": 2}, device="cpu")
        init, step, _, _ = gpt.make_train_step(cfg, mesh)
        state = init(params=gpt.params_from_numpy(config["params"], "cpu"))
        batch = {"tokens": torch.from_numpy(config["tokens"])}
        for i in range(2):
            state, m = step(state, batch)
            train.report({"loss": m["loss"].item(), "step": i,
                          "world": dist.get_world_size(),
                          "backend": dist.get_backend()})

    np_tree, tokens = _nano_np_tree(), _tokens()
    r = TorchTrainer(
        loop, train_loop_config={"params": np_tree, "tokens": tokens},
        torch_config=TorchBackendConfig(multi_controller=True),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert r.error is None
    assert [(m["world"], m["backend"]) for m in r.metrics_history] == \
        [(2, "gloo")] * 2
    cfg = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.float32)
    init, step, _, _ = gpt.make_train_step(cfg, device="cpu")
    state = init(params=gpt.params_from_numpy(np_tree, "cpu"))
    _, m = step(state, {"tokens": torch.from_numpy(tokens)})
    assert abs(r.metrics_history[0]["loss"] - m["loss"].item()) <= LOSS_TOL
    assert r.metrics_history[1]["loss"] < r.metrics_history[0]["loss"]
