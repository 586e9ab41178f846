"""The port stands alone: ``ray_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor ``ml_dtypes`` nor anything of the JAX package
``ray_tpu`` or of the developer tools under ``tools/``.

Checked twice: by an AST scan of every file in the package (the threefry
PRNG and the drafters, which reimplement JAX's and copy the reference's,
included) and of ``chip_smoke.py``, and by serving nano requests
(greedy, seeded temperature > 0, and speculative with the n-gram
drafter), serving one request with the flight recorder on a temporary
directory and reading its ring back, handing one request off from a prefill engine to a decode
engine, serving one request through ``@batch(continuous=True)`` with
tracing on and reading its ``engine.admission`` span back, running batch inference with a progress log and resuming it
once from the log, taking a nano train step (flash attention, ``dots``
remat), and serving one request and taking one train step with a nano
Mixture-of-Experts model, one ResNet-18 forward at inference (through
the predictor's ``uint8_input`` path) and one in training, serving
one request on a tp=2 engine, one local PPO iteration on a numpy
environment, one SAC update with CQL's regularizer, one DreamerV3
update, one multi-agent PPO iteration and one IMPALA iteration on two
runner threads, in
a fresh interpreter where ``jax`` and ``ml_dtypes`` are poisoned in
``sys.modules`` and an import hook refuses them, ``optax``,
``gymnasium``, ``tools``, and ``ray_tpu`` and ``ray_tpu.*`` (but not
``ray_tpu_torch``). The AST scan also refuses ``optax`` anywhere and a
module-level ``gymnasium`` import (the card's machine has neither). A subprocess, because this
suite's conftest imports JAX into the test process. The tp=2 engine's
follower process is spawned afresh, without that block, so it reports
the modules it imported over the group, after serving, and none of
them may be ``jax``, ``ml_dtypes`` or ``ray_tpu``. The same holds for a
sharded training step: two rank processes of a ``RankPool``, spawned
from a script whose controller holds the block, take a nano step on
``{fsdp: 2}``, on ``{tp: 2}``, through the pipeline on ``{pp: 2}`` and
with a Mixture-of-Experts model on ``{tp: 2}``, and report their
modules.
"""
import ast
import os
import subprocess
import sys
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ray_tpu_torch")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "ray_tpu", "optax", "tools")


def test_no_jax_or_reference_imports_in_source():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    assert len(files) >= 10
    for must in ("_private/prng.py", "_private/tp.py", "serve/draft.py",
                 "serve/handoff.py", "_private/ranks.py", "parallel/mesh.py",
                 "parallel/sharding.py", "collective/collective.py",
                 "ops/ring_attention.py", "train/checkpoint.py",
                 "train/session.py", "parallel/pipeline.py",
                 "parallel/multislice.py", "models/moe.py",
                 "models/resnet.py", "rllib/rl_module.py",
                 "rllib/conv_module.py", "rllib/_optim.py",
                 "rllib/learner.py", "rllib/connectors.py",
                 "rllib/env_runner.py", "rllib/algorithm.py",
                 "rllib/ppo.py", "rllib/replay_buffer.py", "rllib/dqn.py",
                 "rllib/sac.py", "rllib/offline_data.py", "rllib/cql.py",
                 "rllib/bc.py", "rllib/marwil.py", "rllib/_threads.py",
                 "rllib/multi_agent.py", "rllib/dreamerv3.py",
                 "rllib/impala.py", "rllib/appo.py", "data/__init__.py",
                 "data/block.py", "data/llm.py", "_private/events.py",
                 "_private/metrics.py", "serve/request.py",
                 "serve/batching.py", "util/tracing.py"):
        assert os.path.join(PKG, must) in files, must
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    bad = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad


def test_gymnasium_only_imported_inside_functions():
    """The port names environments through gymnasium only when asked to
    (``AlgorithmConfig.make_env_creator``), so no module imports it at
    import time: the card's machine has no gymnasium."""
    bad = []
    for d, _, fs in os.walk(PKG):
        for f in fs:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in tree.body:
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                bad += [(path, n) for n in names
                        if n.split(".")[0] == "gymnasium"]
    assert not bad, bad


_CHILD = r"""
import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "ml_dtypes", "ray_tpu", "optax", "gymnasium",
           "tools")
sys.modules["jax"] = None          # `import jax` raises ImportError
sys.modules["ml_dtypes"] = None


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, _Refuse())

import dataclasses
import tempfile

import numpy as np
import torch

# One intra-op thread, as in the test process (tests/torch_threads.py).
torch.set_num_threads(1)

from ray_tpu_torch._private import events as ev
from ray_tpu_torch._private.metrics import serve_metrics
from ray_tpu_torch.models import gpt
from ray_tpu_torch.serve.batching import _EngineStream
from ray_tpu_torch.serve.engine import DecodeEngine

cfg = gpt.CONFIGS["nano"]
params = gpt.init_params(cfg, seed=0, device="cpu")
# The flight recorder on a temporary directory, read back; the serve
# metrics in the port's own registry.
with tempfile.TemporaryDirectory() as evdir:
    rec = ev.init(evdir, proc="isolated")
    eng = DecodeEngine(params, cfg, slots=2, chunk=4, max_len=64,
                       prompt_buckets=(8, 16), page_size=8, device="cpu",
                       deployment="isolated")
    try:
        outs = [np.concatenate(list(eng.stream(
            np.arange(n, dtype=np.int32) % cfg.vocab_size, 6)))
            for n in (5, 11)]
        st = eng.stats()
    finally:
        eng.shutdown()
    ring = ev.read_ring(rec.path)
    ev._reset_for_tests()
assert [o.shape for o in outs] == [(6,), (6,)], outs
kinds = [e["kind"] for e in ring["events"]]
assert ring["torn"] == 0 and kinds.count("engine.admit") == 2, kinds
assert kinds.count("engine.dispatch") == st["dispatches"] > 0, (kinds, st)
assert st["events"]["enabled"] and st["events"]["dropped"] == {}, st
tokens = dict(serve_metrics()["engine_tokens"].collect())
assert tokens[(("deployment", "isolated"),)] == 12, tokens
for kw in (dict(temperature=0.8), dict(spec_decode="ngram", paged=False)):
    eng = DecodeEngine(params, cfg, slots=2, chunk=4, max_len=64,
                       prompt_buckets=(8, 16), device="cpu", **kw)
    try:
        out = np.concatenate(list(eng.stream(
            np.arange(7, dtype=np.int32), 9, seed=3)))
    finally:
        eng.shutdown()
    assert out.shape == (9,) and (out < cfg.vocab_size).all(), (kw, out)
# One handoff: a bf16 prefill engine exports, a decode engine imports.
bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
pre = DecodeEngine(params, bcfg, slots=2, chunk=4, max_len=64,
                   prompt_buckets=(8, 16), page_size=8, role="prefill",
                   device="cpu")
dec = DecodeEngine(params, bcfg, slots=2, chunk=4, max_len=64,
                   prompt_buckets=(8, 16), paged=False, role="decode",
                   device="cpu")
try:
    desc = pre.handoff(np.arange(7, dtype=np.int32), 6, seed=1)
    assert desc["payload"]["k"].dtype == np.uint16
    out = np.concatenate(list(_EngineStream(dec.admit_prefilled(desc))))
    ho = dec.stats()["handoff"]
finally:
    pre.shutdown()
    dec.shutdown()
assert out.shape == (6,) and ho["imported"] == 1, (out, ho)
assert ho["import_fallbacks"] == 0, ho
# One request through the port's @batch(continuous=True) with tracing on:
# its engine.admission span parents under the request's span.
from ray_tpu_torch.serve import batching, request
from ray_tpu_torch.util import tracing

eng = DecodeEngine(params, cfg, slots=2, chunk=4, max_len=64,
                   prompt_buckets=(8, 16), page_size=8, device="cpu",
                   deployment="isolated-batch")


class Deployment:
    @batching.batch(continuous=True, page_size=8)
    def decode(self, prompt):
        return eng, {"prompt": prompt, "max_new": 6}


tracing.enable()
tok = request._request_deadline.set(request.make_deadline(120.0))
try:
    with tracing.span("request") as root:
        out = np.concatenate(list(Deployment().decode(
            np.arange(5, dtype=np.int32))))
finally:
    request._request_deadline.reset(tok)
    tracing.disable()
    eng.shutdown()
assert out.shape == (6,), out
adm = [s for s in tracing.drain() if s["name"] == "engine.admission"]
assert len(adm) == 1 and adm[0]["parent_id"] == root["span_id"], adm
assert adm[0]["attrs"]["deployment"] == "isolated-batch", adm
assert tracing.dropped_total() == 0
# Batch inference with a progress log: a run left after its first block,
# then resumed once from the log.
import shutil
import tempfile

from ray_tpu_torch import data as tdata

log_dir = tempfile.mkdtemp()
rows = [{"rid": i, "prompt": np.arange(3 + i, dtype=np.int32)}
        for i in range(5)]
blocks = [tdata.block.rows_to_block(rows[i:i + 2]) for i in (0, 2, 4)]
runs = []
try:
    for stop_after in (1, None):
        eng = DecodeEngine(params, cfg, slots=2, chunk=4, max_len=64,
                           prompt_buckets=(8, 16), page_size=8,
                           temperature=0.8, device="cpu")
        try:
            bi = tdata.BatchInferencer(eng, max_new=5, seed=3,
                                       progress_path=log_dir)
            gen = bi.run(blocks)
            got = [r for _, b in zip(range(stop_after or 3), gen)
                   for r in tdata.block.iter_rows(b)]
            gen.close()
            runs.append((got, dict(bi.stats), eng.stats()["admitted"]))
        finally:
            eng.shutdown()
finally:
    shutil.rmtree(log_dir, ignore_errors=True)
(first, _, _), (resumed, stats, admitted) = runs
assert [r["rid"] for r in resumed] == list(range(5)), resumed
assert stats["blocks_from_log"] >= 1 and admitted == 5 - stats[
    "rows_resumed_from_log"], (stats, admitted)
assert all(np.array_equal(a["generated"], b["generated"])
           and a["generated"].shape == (5,) for a, b in zip(first, resumed))
tcfg = dataclasses.replace(cfg, attn_backend="flash", remat="dots")
init, step, _, _ = gpt.make_train_step(tcfg, device="cpu")
state, metrics = step(init(seed=0), {"tokens": np.arange(
    2 * 17, dtype=np.int64).reshape(2, 17) % cfg.vocab_size})
assert state["step"] == 1 and bool(torch.isfinite(metrics["loss"]))
# Mixture-of-Experts: one served request and one train step.
mcfg = dataclasses.replace(cfg, n_experts=4)
mparams = gpt.init_params(mcfg, seed=0, device="cpu")
eng = DecodeEngine(mparams, mcfg, slots=2, chunk=4, max_len=64,
                   prompt_buckets=(8, 16), page_size=8, device="cpu")
try:
    out = np.concatenate(list(eng.stream(np.arange(7, dtype=np.int32), 6)))
finally:
    eng.shutdown()
assert out.shape == (6,), out
init, step, _, _ = gpt.make_train_step(dataclasses.replace(tcfg, n_experts=4),
                                 device="cpu")
state, metrics = step(init(seed=0), {"tokens": np.arange(
    2 * 17, dtype=np.int64).reshape(2, 17) % cfg.vocab_size})
assert float(metrics["moe_aux"]) > 0, metrics
# ResNet: one forward at inference and one in training.
from ray_tpu_torch.models import resnet

rcfg = resnet.ResNetConfig(depth=18, num_classes=10, width=8,
                           dtype=torch.float32)
rparams = resnet.init_params(rcfg, 0, device="cpu")
images = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                           dtype=np.uint8)
logits = resnet.make_predictor(rcfg, rparams, uint8_input=True)(images)
assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())
logits, new = resnet.forward(rparams, torch.rand(2, 32, 32, 3), rcfg,
                             train=True)
assert not torch.equal(new["stem"]["bn"]["mean"],
                       rparams["stem"]["bn"]["mean"])
# Tensor parallelism: a tp=2 engine; its follower reports its modules.
from ray_tpu_torch._private import tp

eng = DecodeEngine(params, cfg, slots=2, chunk=4, max_len=64,
                   prompt_buckets=(8, 16), page_size=8, tp=2, device="cpu")
try:
    out = np.concatenate(list(eng.stream(np.arange(7, dtype=np.int32), 6)))
finally:
    eng.shutdown()
assert out.shape == (6,), out
report, = tp.decode_group(2).probe()
assert "torch" in report["modules"], report
follower = sorted(set(report["modules"]) & set(BLOCKED))
assert not follower, follower
# RL: one local PPO iteration on a numpy env, one SAC (with CQL) update.
import types

from ray_tpu_torch import rllib


class Walk:
    observation_space = types.SimpleNamespace(shape=(3,))
    action_space = types.SimpleNamespace(n=2)

    def reset(self, *, seed=None, options=None):
        self.rng = np.random.default_rng(seed) if seed is not None \
            else self.rng
        self.t, self.x = 0, self.rng.standard_normal(3).astype(np.float32)
        return self.x, {}

    def step(self, action):
        self.t += 1
        self.x = (self.x + (0.1 if action else -0.1)).astype(np.float32)
        return self.x, float(action), bool(abs(self.x[0]) > 2), \
            self.t >= 20, {}


algo = (rllib.PPOConfig().environment(env_creator=Walk)
        .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
        .rl_module(hidden=(8, 8))
        .training(train_batch_size=32, minibatch_size=16, num_epochs=2)
        .learners(device="cpu").debugging(seed=0)).build()
m = algo.train()
algo.stop()
assert np.isfinite(m["total_loss"]) and m["num_env_steps_trained"] == 32, m
spec = rllib.RLModuleSpec(obs_dim=3, num_actions=1, hidden=(8, 8),
                          continuous=True, action_low=np.array([-1.0]),
                          action_high=np.array([1.0]),
                          module_cls=rllib.SquashedGaussianModule)
sac = rllib.SACLearner(spec, cql_weight=1.0, cql_num_actions=2,
                       device="cpu")
rng = np.random.default_rng(0)
m = sac.update({"obs": rng.standard_normal((8, 3)),
                "actions": rng.uniform(-1, 1, (8, 1)),
                "rewards": rng.standard_normal(8),
                "next_obs": rng.standard_normal((8, 3)),
                "dones": np.zeros(8)})
assert m["cql_loss"] > 0 and np.isfinite(m["critic_loss"]), m
# DreamerV3: one update at a tiny size.
cfg = rllib.DreamerV3Config().environment(env_creator=Walk)
cfg.deter_dim = cfg.units = 16
cfg.stoch_dims = cfg.stoch_classes = 2
cfg.horizon, cfg.seq_len, cfg.batch_seqs = 3, 4, 2
dv3 = rllib.DreamerV3Learner(cfg.module_spec(), cfg, device="cpu")
m = dv3.update({"obs": rng.standard_normal((2, 4, 3)).astype(np.float32),
                "a_prev": rng.integers(0, 2, (2, 4)),
                "rewards": rng.random((2, 4)).astype(np.float32),
                "terms": np.zeros((2, 4), np.float32),
                "is_first": np.eye(2, 4, dtype=np.float32)})
assert np.isfinite(m["loss"]), m


class Pair(rllib.MultiAgentEnv):
    possible_agents = ["a", "b"]
    observation_spaces = {a: Walk.observation_space for a in possible_agents}
    action_spaces = {a: Walk.action_space for a in possible_agents}

    def reset(self, *, seed=None, options=None):
        self.t = 0
        return {a: np.full(3, 0.0, np.float32) for a in "ab"}, {}

    def step(self, actions):
        self.t += 1
        obs = {a: np.full(3, self.t, np.float32) for a in "ab"}
        rew = {a: float(v) for a, v in actions.items()}
        return obs, rew, {"__all__": self.t >= 5}, {"__all__": False}, {}


# Multi-agent PPO: one iteration, a learner group per module.
algo = (rllib.PPOConfig().environment(env_creator=Pair)
        .multi_agent(policies={"a", "b"})
        .env_runners(rollout_fragment_length=8).rl_module(hidden=(8,))
        .training(train_batch_size=16, minibatch_size=8, num_epochs=1)
        .learners(device="cpu")).build()
m = algo.train()
algo.stop()
assert np.isfinite(m["module/a/total_loss"]), m
# IMPALA: one iteration on two runner threads.
algo = (rllib.IMPALAConfig().environment(env_creator=Walk)
        .env_runners(num_env_runners=2, rollout_fragment_length=8)
        .rl_module(hidden=(8, 8)).training(minibatch_size=8)
        .learners(device="cpu").debugging(seed=0)).build()
m = algo.train()
algo.stop()
assert np.isfinite(m["total_loss"]) and m["num_fragments"] >= 1, m
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ISOLATED-OK")
"""


def test_serves_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "ISOLATED-OK" in res.stdout


_SHARDED = r"""
import sys


def rank_step(axes, backend, **kw):
    import dataclasses

    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import create_mesh

    cfg = dataclasses.replace(gpt.CONFIGS["nano"], attn_backend=backend,
                              **kw)
    mesh = create_mesh(axes, device="cpu")
    init, step, _, _ = gpt.make_train_step(cfg, mesh)
    state, m = step(init(seed=0), {"tokens": np.arange(
        4 * 17, dtype=np.int64).reshape(4, 17) % cfg.vocab_size})
    assert state["step"] == 1 and bool(torch.isfinite(m["loss"]))
    return sorted({name.split(".")[0] for name in sys.modules})


if __name__ == "__main__":
    import importlib.abc

    BLOCKED = ("jax", "jaxlib", "ml_dtypes", "ray_tpu")
    sys.modules["jax"] = None
    sys.modules["ml_dtypes"] = None

    class _Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, _Refuse())
    from ray_tpu_torch._private.ranks import RankPool

    with RankPool(2, devices=("cpu",) * 2) as pool:
        for axes, backend, kw in (({"fsdp": 2}, "xla", {}),
                                  ({"tp": 2}, "flash", {}),
                                  ({"pp": 2}, "flash", {"pp_axis": "pp"}),
                                  ({"tp": 2}, "flash", {"n_experts": 4})):
            for modules in pool.run(rank_step, axes, backend, **kw):
                assert "torch" in modules, modules
                bad = sorted(set(modules) & set(BLOCKED))
                assert not bad, bad
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("SHARDED-ISOLATED-OK")
"""


def test_sharded_step_with_jax_and_reference_blocked(tmp_path):
    """Two CPU ranks take a nano train step on {fsdp: 2}, on {tp: 2}, on
    {pp: 2} and MoE on {tp: 2} (flash, its plain versions here) from a
    controller that blocks JAX and the reference; the ranks report the
    modules they imported."""
    script = tmp_path / "sharded_child.py"
    script.write_text(_SHARDED)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, str(script)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "SHARDED-ISOLATED-OK" in res.stdout
