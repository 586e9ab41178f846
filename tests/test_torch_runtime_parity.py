"""The port's runtime against the reference's: one scenario program,
written to ``tmp_path`` and run twice, once over ``ray_tpu`` and once over
``ray_tpu_torch``, each in a subprocess of its own (the two runs go
together). Each run prints one JSON object of what it observed, and the
two objects must be equal.

The scenario covers nested ``put``/``get`` of numpy values and a 50-task
fan-out (after which neither the driver nor a worker has imported torch
or jax); nested submission, ``num_returns=2`` and streaming generators;
the ready/pending split of ``wait``; an actor's call order and state;
task and actor errors (the ``exceptions.py`` class names and the cause);
``GetTimeoutError`` and ``kill`` → ``ActorDiedError``; PACK and
STRICT_SPREAD feasibility on one node; ``available_resources()`` while an
actor holds a CPU; and the key sets of ``state("summary")`` and of a
timeline event, and the metric names ``metrics_text()`` exposes. The
accelerator resource is the one difference the packages are meant to
have (``TPU`` against ``GPU``), so the scenario reports it under one
name.
"""
import json
import os
import subprocess
import sys

from torch_runtime import case_time_limit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE_LIMIT_S = 150.0

SCENARIO = r'''
import importlib
import json
import re
import sys
import time

import numpy as np

PKG = sys.argv[1]
rt = importlib.import_module(PKG)
ACCEL = "GPU" if PKG == "ray_tpu_torch" else "TPU"
rt.init(num_cpus=4, **{f"num_{ACCEL.lower()}s": 0})
out = {}


def accel(res):
    res = dict(res)
    res["ACCEL"] = res.pop(ACCEL, None)
    return {k: res[k] for k in sorted(res)}


# nested put/get with numpy, and a fan-out
inner = rt.put(np.arange(6.0).reshape(2, 3))
outer = rt.put({"inner": inner, "big": np.ones(1 << 18, np.float32)})
got = rt.get(outer)
out["nested"] = [rt.get(got["inner"]).tolist(), float(got["big"].sum()),
                 bool(got["big"].flags.writeable)]


@rt.remote
def sq(x):
    return x * x


out["fanout"] = rt.get([sq.remote(i) for i in range(50)])


@rt.remote
def heavy_modules():
    return sorted(m for m in ("torch", "jax") if m in sys.modules)


# neither the driver nor a worker imported torch (or jax): no value held
# a tensor
out["heavy_modules"] = [rt.get(heavy_modules.remote()),
                        sorted(m for m in ("torch", "jax")
                               if m in sys.modules)]


# nested submission, two returns, a generator
@rt.remote
def outer_task(n):
    return sum(rt.get([sq.remote(i) for i in range(n)]))


@rt.remote(num_returns=2)
def two(x):
    return x, -x


@rt.remote
def gen(n):
    for i in range(n):
        yield {"i": i, "sq": i * i}


a, b = two.remote(7)
out["nested_submit"] = rt.get(outer_task.remote(10))
out["two"] = rt.get([a, b])
out["gen"] = [rt.get(r) for r in
              gen.options(num_returns="streaming").remote(4)]


# wait: the ready/pending split
@rt.remote
def sleepy(s):
    time.sleep(s)
    return s


@rt.remote
def quick(x):
    return x


# (one call of each function: calls of one function may share a lease
# and come back as one chunk)
refs = [quick.remote(0), sleepy.remote(3.0), rt.put(2)]
ready, pending = rt.wait(refs, num_returns=2, timeout=2.5)
out["wait"] = [[refs.index(r) for r in ready],
               [refs.index(r) for r in pending]]
ready, pending = rt.wait(refs, num_returns=3, timeout=0.1)
out["wait_timeout"] = [len(ready), len(pending)]


# an actor: call order and state
@rt.remote
class Log:
    def __init__(self, start):
        self.items = [start]

    def add(self, x):
        self.items.append(x)
        return len(self.items)

    def read(self):
        return list(self.items)

    def fail(self):
        raise ValueError("actor method failed")


def settle(timeout=20.0):
    """Available resources once every idle worker lease went back (a
    lease outlives its task for a while), or as they stand at the
    timeout."""
    deadline = time.time() + timeout
    while True:
        res = accel(rt.available_resources())
        if res["CPU"] == 4.0 or time.time() > deadline:
            return res
        time.sleep(0.1)


rt.get(refs)
res_idle = settle()
log = Log.remote("s")
lens = [log.add.remote(i) for i in range(10)]
out["actor"] = [rt.get(lens), rt.get(log.read.remote())]
res_during = accel(rt.available_resources())


# errors
@rt.remote
def boom():
    raise KeyError("missing")


def err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return [type(e).__name__, getattr(e, "cause_type", None),
                getattr(e, "message", None),
                isinstance(e, rt.exceptions.RayTpuError),
                isinstance(e, TimeoutError)]
    return None


out["task_error"] = err(lambda: rt.get(boom.remote()))
out["actor_error"] = err(lambda: rt.get(log.fail.remote()))
out["actor_alive_after_error"] = rt.get(log.add.remote("x"))
slow = sleepy.remote(2.0)
out["get_timeout"] = err(lambda: rt.get(slow, timeout=0.2))
rt.kill(log)
time.sleep(0.3)
kerr = err(lambda: rt.get(log.read.remote(), timeout=10))
out["killed"] = [kerr[0], kerr[1], kerr[3]]


# placement groups on one node
pack = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
out["pack_ready"] = pack.ready(timeout=15)
res_pg = accel(rt.available_resources())
rt.remove_placement_group(pack)
spread = rt.placement_group([{"CPU": 1}, {"CPU": 1}],
                            strategy="STRICT_SPREAD")
try:
    out["strict_spread_ready"] = spread.ready(timeout=1.0)
except Exception as e:  # noqa: BLE001
    out["strict_spread_ready"] = type(e).__name__
rt.remove_placement_group(spread)
out["slow"] = rt.get(slow)
time.sleep(0.3)
res_after = settle()
for name, res in (("idle", res_idle), ("during_actor", res_during),
                  ("during_pack", res_pg), ("after", res_after)):
    out["available_" + name] = {k: res[k] for k in ("CPU", "ACCEL")}

# observability: key sets and names
summary = rt.state("summary")
out["summary_keys"] = sorted(summary)
out["summary_resource_keys"] = sorted(accel(summary["resources_total"]))
events = rt.timeline()
out["timeline_keys"] = sorted(set().union(*(e.keys() for e in events)))
out["metric_names"] = sorted(set(re.findall(r"^# TYPE (\S+) ",
                                            rt.metrics_text(), re.M)))
rt.shutdown()
print("SCENARIO " + json.dumps(out, sort_keys=True))
'''


def _run_both(tmp_path):
    path = tmp_path / "scenario.py"
    path.write_text(SCENARIO)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = {pkg: subprocess.Popen(
        [sys.executable, str(path), pkg], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, p in procs.items():
        stdout, stderr = p.communicate(timeout=120)
        lines = [ln for ln in stdout.splitlines()
                 if ln.startswith("SCENARIO ")]
        assert p.returncode == 0 and lines, (pkg, p.returncode,
                                             stderr[-3000:])
        results[pkg] = json.loads(lines[-1][len("SCENARIO "):])
    return results


def test_runtime_scenario_equal_to_reference(tmp_path):
    got = _run_both(tmp_path)
    ref, port = got["ray_tpu"], got["ray_tpu_torch"]
    assert ref.keys() == port.keys()
    for key in ref:
        assert port[key] == ref[key], key
    # the scenario saw what it was written to see
    assert port["fanout"] == [i * i for i in range(50)]
    assert port["heavy_modules"] == [[], []]
    assert sorted(port["wait"][0]) == [0, 2] and port["wait"][1] == [1]
    assert port["task_error"][:2] == ["TaskError", "KeyError"]
    assert port["killed"][:2] == ["TaskError", "ActorDiedError"]
    assert port["get_timeout"][0] == "GetTimeoutError"
    assert port["pack_ready"] is True
    assert port["strict_spread_ready"] != True  # noqa: E712
    assert port["available_idle"]["CPU"] == 4.0
    assert port["available_during_actor"]["CPU"] == 3.0
    assert port["available_after"]["CPU"] == 4.0
    assert "tasks_finished_total" in " ".join(port["metric_names"])
