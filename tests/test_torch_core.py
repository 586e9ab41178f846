"""The port's core runtime: tasks, objects, errors and actors, the
single-node cases of ``test_core_basic.py`` and ``test_core_actors.py``
run against ``ray_tpu_torch``, with tensor cases beside the numpy ones.

One runtime serves the whole module (``torch_runtime.rt_port``); the
reference's ``rt_fresh`` cases (kill, restart) run on it too, since each
builds its own actor.
"""
import time

import numpy as np
import pytest
import torch

from torch_runtime import case_time_limit, rt_port  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


# ------------------------------------------------------------ tasks/objects


def test_put_get(rt_port):
    rt = rt_port
    ref = rt.put({"a": 1, "b": [1, 2, 3]})
    assert rt.get(ref) == {"a": 1, "b": [1, 2, 3]}


def test_large_object_shm(rt_port):
    rt = rt_port
    arr = np.random.rand(500_000).astype(np.float32)
    out = rt.get(rt.put(arr))
    np.testing.assert_array_equal(arr, out)


def test_large_tensor_shm(rt_port):
    rt = rt_port
    t = torch.from_numpy(np.random.default_rng(0).random(500_000,
                                                         np.float32))
    out = rt.get(rt.put(t))
    assert out.dtype == torch.float32 and torch.equal(out, t)


def test_simple_task(rt_port):
    rt = rt_port

    @rt.remote
    def f(x):
        return x + 1

    assert rt.get(f.remote(1)) == 2


def test_task_fanout(rt_port):
    rt = rt_port

    @rt.remote
    def sq(x):
        return x * x

    refs = [sq.remote(i) for i in range(50)]
    assert rt.get(refs) == [i * i for i in range(50)]


def test_task_args_kwargs(rt_port):
    rt = rt_port

    @rt.remote
    def g(a, b, c=0, d=0):
        return a + b + c + d

    assert rt.get(g.remote(1, 2, c=3, d=4)) == 10


def test_task_ref_arg(rt_port):
    rt = rt_port

    @rt.remote
    def h(x):
        return x * 2

    ref = rt.put(21)
    assert rt.get(h.remote(ref)) == 42


def test_chained_tasks(rt_port):
    rt = rt_port

    @rt.remote
    def inc(x):
        return x + 1

    r = inc.remote(0)
    for _ in range(5):
        r = inc.remote(r)
    assert rt.get(r) == 6


def test_large_arg_and_return(rt_port):
    rt = rt_port

    @rt.remote
    def double(a):
        return a * 2

    arr = np.arange(300_000, dtype=np.float64)
    np.testing.assert_array_equal(rt.get(double.remote(arr)), arr * 2)


def test_large_tensor_arg_and_return(rt_port):
    """A tensor goes to a worker as an argument and comes back as a
    result, dtype and values kept (bf16 bit for bit)."""
    rt = rt_port

    @rt.remote
    def double(a):
        return a * 2

    t = torch.arange(300_000, dtype=torch.float64)
    out = rt.get(double.remote(t))
    assert out.dtype == torch.float64 and torch.equal(out, t * 2)
    b = torch.randn(256, 512, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    out = rt.get(double.remote(b))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), (b * 2).view(torch.int16))


def test_num_returns(rt_port):
    rt = rt_port

    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c]) == [1, 2, 3]


def test_error_propagation(rt_port):
    rt = rt_port

    @rt.remote
    def boom():
        raise KeyError("missing")

    with pytest.raises(rt.exceptions.TaskError) as ei:
        rt.get(boom.remote())
    assert ei.value.cause_type == "KeyError"


def test_error_through_chain(rt_port):
    rt = rt_port

    @rt.remote
    def boom():
        raise ValueError("first")

    @rt.remote
    def passthrough(x):
        return x

    with pytest.raises(rt.exceptions.TaskError):
        rt.get(passthrough.remote(boom.remote()))


def test_wait(rt_port):
    rt = rt_port

    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(1.0)
        return "slow"

    rs, rf = slow.remote(), fast.remote()
    ready, not_ready = rt.wait([rs, rf], num_returns=1, timeout=5)
    assert ready == [rf]
    assert not_ready == [rs]
    ready, not_ready = rt.wait([rs, rf], num_returns=2, timeout=10)
    assert len(ready) == 2


def test_get_timeout(rt_port):
    rt = rt_port

    @rt.remote
    def hang():
        time.sleep(10)

    with pytest.raises(rt.exceptions.GetTimeoutError):
        rt.get(hang.remote(), timeout=0.3)


def test_cluster_resources(rt_port):
    rt = rt_port
    total = rt.cluster_resources()
    assert total["CPU"] == 8.0
    assert total["GPU"] == 0.0
    assert "TPU" not in total


def test_options_name(rt_port):
    rt = rt_port

    @rt.remote
    def named():
        return 1

    assert rt.get(named.options(name="custom").remote()) == 1


def test_nested_tasks(rt_port):
    rt = rt_port

    @rt.remote
    def inner(x):
        return x + 1

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 10

    assert rt.get(outer.remote(0)) == 11


def test_gpu_detection(monkeypatch):
    """Cards are counted from ``CUDA_VISIBLE_DEVICES`` (empty: none)
    without importing torch, and labelled by their short model name."""
    from ray_tpu_torch._private import accelerators as acc

    for value, n in (("0,1,3", 3), ("", 0), ("2", 1), (" 0 , 1 ", 2)):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", value)
        assert acc.detect_num_gpus() == n, value
    assert acc.short_model_name("NVIDIA H100 80GB HBM3") == "H100"
    assert acc.short_model_name("NVIDIA A100-SXM4-80GB") == "A100"
    assert acc.short_model_name("Tesla V100-SXM2-16GB") == "V100"
    assert acc.gang_resources(2, "H100") == {"accelerator_type:H100": 2.0}
    assert acc.gang_resources(0, "H100") == {}


def test_not_ported_entry_points_raise(rt_port):
    """``address="auto"`` and ``.bind()`` wait for their slices."""
    rt = rt_port

    @rt.remote
    def f():
        return 1

    @rt.remote
    class A:
        def m(self):
            return 1

    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        f.bind()
    a = A.remote()
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        a.m.bind()
    rt.kill(a)
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        rt.init(address="auto")


# ------------------------------------------------------------------ actors


def test_actor_basic(rt_port):
    rt = rt_port

    @rt.remote
    class Counter:
        def __init__(self, v=0):
            self.v = v

        def inc(self, n=1):
            self.v += n
            return self.v

    c = Counter.remote(5)
    assert rt.get(c.inc.remote()) == 6
    assert rt.get(c.inc.remote(4)) == 10


def test_actor_ordering(rt_port):
    rt = rt_port

    @rt.remote
    class Log:
        def __init__(self):
            self.items = []

        def append(self, x):
            self.items.append(x)

        def read(self):
            return self.items

    log = Log.remote()
    for i in range(20):
        log.append.remote(i)
    assert rt.get(log.read.remote()) == list(range(20))


def test_actor_state_isolation(rt_port):
    rt = rt_port

    @rt.remote
    class Holder:
        def __init__(self):
            self.v = 0

        def bump(self):
            self.v += 1
            return self.v

    a, b = Holder.remote(), Holder.remote()
    assert rt.get(a.bump.remote()) == 1
    assert rt.get(a.bump.remote()) == 2
    assert rt.get(b.bump.remote()) == 1


def test_actor_holds_tensor_state(rt_port):
    """An actor keeps a tensor across calls; in-place updates inside the
    actor never reach the caller's copy."""
    rt = rt_port

    @rt.remote
    class Acc:
        def __init__(self, t):
            self.t = t

        def add(self, d):
            self.t.add_(d)
            return self.t

    t = torch.zeros(4, 8)
    a = Acc.remote(t)
    rt.get(a.add.remote(torch.ones(4, 8)))
    out = rt.get(a.add.remote(torch.ones(4, 8)))
    assert torch.equal(out, torch.full((4, 8), 2.0))
    assert torch.equal(t, torch.zeros(4, 8))
    rt.kill(a)


def test_async_actor_concurrency(rt_port):
    rt = rt_port

    @rt.remote
    class A:
        async def go(self):
            import asyncio

            await asyncio.sleep(0.2)
            return 1

    a = A.options(max_concurrency=10).remote()
    rt.get(a.go.remote())  # warm: actor worker spawn + first call
    t0 = time.time()
    assert sum(rt.get([a.go.remote() for _ in range(10)])) == 10
    assert time.time() - t0 < 1.5  # concurrent, not 2s serial


def test_named_actor(rt_port):
    rt = rt_port

    @rt.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="svc_test").remote()
    h = rt.get_actor("svc_test")
    assert rt.get(h.ping.remote()) == "pong"
    rt.kill(h)


def test_actor_handle_passing(rt_port):
    rt = rt_port

    @rt.remote
    class Store:
        def __init__(self):
            self.v = {}

        def set(self, k, v):
            self.v[k] = v

        def get(self, k):
            return self.v.get(k)

    @rt.remote
    def writer(store, k, v):
        rt.get(store.set.remote(k, v))
        return True

    s = Store.remote()
    assert rt.get(writer.remote(s, "x", 42))
    assert rt.get(s.get.remote("x")) == 42


def test_actor_error(rt_port):
    rt = rt_port

    @rt.remote
    class Bad:
        def fail(self):
            raise RuntimeError("actor method failed")

        def ok(self):
            return 1

    b = Bad.remote()
    with pytest.raises(rt.exceptions.TaskError):
        rt.get(b.fail.remote())
    # Actor survives method errors.
    assert rt.get(b.ok.remote()) == 1


def test_kill_actor(rt_port):
    rt = rt_port

    @rt.remote
    class K:
        def ping(self):
            return 1

    k = K.remote()
    assert rt.get(k.ping.remote()) == 1
    rt.kill(k)
    time.sleep(0.3)
    with pytest.raises(rt.exceptions.TaskError) as ei:
        rt.get(k.ping.remote(), timeout=10)
    assert ei.value.cause_type == "ActorDiedError"


def test_actor_restart(rt_port):
    rt = rt_port

    @rt.remote
    class Dier:
        def __init__(self):
            self.n = 0

        def crash(self):
            import os

            os._exit(1)

        def ping(self):
            self.n += 1
            return self.n

    d = Dier.options(max_restarts=2).remote()
    assert rt.get(d.ping.remote()) == 1
    d.crash.remote()
    # Wait for head to detect death + restart.
    deadline = time.time() + 15
    while time.time() < deadline:
        try:
            # Fresh instance => counter reset to 1.
            if rt.get(d.ping.remote(), timeout=10) == 1:
                break
        except Exception:
            time.sleep(0.2)
    else:
        pytest.fail("actor did not restart")
    rt.kill(d)


def test_list_actors(rt_port):
    rt = rt_port

    @rt.remote
    class L:
        def x(self):
            return 1

    a = L.options(name="listed_actor").remote()
    infos = rt.list_actors()
    names = {i["name"] for i in infos}
    assert "listed_actor" in names
    rt.kill(a)


def test_local_class_with_super_ships_by_value(rt_port):
    """A class defined in a test body whose method calls ``super()``
    (the ``__class__`` cell) and a lambda in a closure travel by value
    through the vendored cloudpickle."""
    rt = rt_port
    k = 3

    class Base:
        def value(self):
            return 10

    @rt.remote
    class Child(Base):
        def value(self):
            return super().value() + k

        def apply(self, fn, x):
            return fn(x)

    c = Child.remote()
    assert rt.get(c.value.remote()) == 13
    assert rt.get(c.apply.remote(lambda x: x * k, 5)) == 15
    rt.kill(c)


def test_task_and_actor_spans_share_trace(rt_port, monkeypatch):
    """The tracing plane's runtime half: a task and an actor call
    submitted under a span record a submit span in the driver and an
    execute span in the worker, one trace end to end, read back from the
    head with ``get_spans`` (the cases of ``test_tracing.py``)."""
    from ray_tpu_torch.util import tracing

    rt = rt_port
    monkeypatch.setattr(tracing, "_enabled", True)

    @rt.remote
    def traced_fn(x):
        return x + 1

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    rt.get(c.incr.remote())
    with tracing.span("request", user="test") as ctx:
        assert rt.get(traced_fn.remote(41)) == 42
        assert rt.get(c.incr.remote()) == 2
    trace_id = ctx["trace_id"]
    deadline = time.time() + 10
    while True:
        spans = [s for s in tracing.get_spans()
                 if s["trace_id"] == trace_id]
        if sum(s["kind"] == "execute" for s in spans) >= 2 or \
                time.time() > deadline:
            break
        time.sleep(0.2)
    by_name = {s["name"]: s for s in spans}
    root = by_name["request"]
    assert root["kind"] == "internal" and root["attrs"] == {"user": "test"}
    for fn in ("traced_fn", "incr"):
        sub = next(s for s in spans if s["kind"] == "submit"
                   and s["name"].endswith(fn))
        ex = next(s for s in spans if s["kind"] == "execute"
                  and s["name"].endswith(fn))
        assert sub["parent_id"] == root["span_id"]
        assert ex["parent_id"] == sub["span_id"]
        assert ex["process"] != root.get("process")
    rt.kill(c)
