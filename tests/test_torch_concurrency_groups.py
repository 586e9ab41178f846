"""Actor concurrency groups in the port's runtime, the cases of
``test_concurrency_groups.py`` run against ``ray_tpu_torch`` (reference:
``src/ray/core_worker/transport/concurrency_group_manager.h``,
``ray.method(concurrency_group=)``): named per-group thread pools so a
slow group can't starve another."""
import time

import pytest

import ray_tpu_torch as rt

from torch_runtime import case_time_limit, rt_port  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def cg_actor(rt_port):
    @rt.remote(concurrency_groups={"io": 2, "compute": 1})
    class Worker:
        def __init__(self):
            self.log = []

        @rt.method(concurrency_group="io")
        def fetch(self, i, delay=0.0):
            if delay:
                time.sleep(delay)
            self.log.append(("io", i))
            return f"io-{i}"

        @rt.method(concurrency_group="compute")
        def crunch(self, i):
            self.log.append(("compute", i))
            return f"compute-{i}"

        def plain(self, i):
            return f"plain-{i}"

        def get_log(self):
            return list(self.log)

    yield Worker.remote()


def test_group_methods_run_and_route(cg_actor):
    a = cg_actor
    assert rt.get(a.fetch.remote(1), timeout=30) == "io-1"
    assert rt.get(a.crunch.remote(2), timeout=30) == "compute-2"
    # ungrouped methods use the actor's default executor
    assert rt.get(a.plain.remote(3), timeout=30) == "plain-3"


def test_slow_group_does_not_starve_other_group(cg_actor):
    """Two long io calls saturate the io group (2 threads); a compute
    call submitted AFTER them must still complete long before they do."""
    a = cg_actor
    t0 = time.time()
    slow = [a.fetch.remote(i, delay=4.0) for i in range(2)]
    got = rt.get(a.crunch.remote(99), timeout=30)
    compute_latency = time.time() - t0
    assert got == "compute-99"
    assert compute_latency < 3.0, compute_latency  # didn't wait for io
    assert rt.get(slow, timeout=30) == ["io-0", "io-1"]


def test_per_call_group_override(cg_actor):
    a = cg_actor
    # route an ungrouped method into the io group explicitly
    got = rt.get(a.plain.options(concurrency_group="io").remote(7),
                 timeout=30)
    assert got == "plain-7"


def test_unknown_group_errors(cg_actor):
    from ray_tpu_torch.exceptions import TaskError

    a = cg_actor
    with pytest.raises(Exception) as ei:
        rt.get(a.plain.options(concurrency_group="nope").remote(1),
               timeout=30)
    assert "concurrency group" in str(ei.value)


def test_async_methods_respect_group_limit(rt_port):
    """Coroutine methods are bounded by a per-group semaphore of the
    same width as the group's thread pool."""
    @rt.remote(concurrency_groups={"serial": 1}, max_concurrency=8)
    class AsyncProbe:
        def __init__(self):
            self.active = 0
            self.max_active = 0

        @rt.method(concurrency_group="serial")
        async def step(self):
            import asyncio

            self.active += 1
            self.max_active = max(self.max_active, self.active)
            await asyncio.sleep(0.05)
            self.active -= 1
            return self.max_active

        async def peak(self):
            return self.max_active

    p = AsyncProbe.remote()
    rt.get([p.step.remote() for _ in range(6)], timeout=60)
    assert rt.get(p.peak.remote(), timeout=30) == 1


def test_group_limit_bounds_parallelism(rt_port):
    """A 1-thread group serializes its calls even under a burst."""
    @rt.remote(concurrency_groups={"serial": 1})
    class Probe:
        def __init__(self):
            self.active = 0
            self.max_active = 0

        @rt.method(concurrency_group="serial")
        def step(self):
            self.active += 1
            self.max_active = max(self.max_active, self.active)
            time.sleep(0.05)
            self.active -= 1
            return self.max_active

        def peak(self):
            return self.max_active

    p = Probe.remote()
    rt.get([p.step.remote() for _ in range(6)], timeout=60)
    assert rt.get(p.peak.remote(), timeout=30) == 1
