"""Reference-counting GC + streaming generators in the port's runtime:
the cases of ``test_core_gc_generators.py`` run against
``ray_tpu_torch`` (one runtime for the module), with a tensor case.

Mirrors the reference's test strategy for these subsystems
(``python/ray/tests/test_reference_counting.py``,
``test_streaming_generator.py``): observe store occupancy around ref
lifetimes, and assert items stream before task completion.
"""
import gc
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core.worker import CoreWorker

from torch_runtime import case_time_limit, rt_port  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def _store_size():
    return CoreWorker.current().memory_store.size()


def _shm_used():
    return CoreWorker.current().shm_store.used_bytes()


def test_put_del_frees_memory_store(rt_port):
    # Grace-delayed borrow releases from earlier tests can free entries
    # mid-test; settle first, then allow only shrinkage.
    before = _store_size()
    deadline = time.time() + 8
    while time.time() < deadline:
        time.sleep(0.5)
        now = _store_size()
        if now == before:
            break
        before = now
    ref = rt.put({"some": "value"})
    assert _store_size() == before + 1
    del ref
    gc.collect()
    # Ref-dec processing is batched onto the IO-loop sweeper (~100ms
    # cadence); the free is asynchronous but prompt.
    deadline = time.time() + 2
    while time.time() < deadline and _store_size() > before:
        time.sleep(0.05)
    assert _store_size() <= before


def test_put_del_frees_shm(rt_port):
    before = _shm_used()
    ref = rt.put(np.zeros(1 << 20, dtype=np.float32))  # 4 MB -> shm tier
    assert _shm_used() >= before + (1 << 22)
    del ref
    gc.collect()
    deadline = time.time() + 2   # async sweeper-batched free
    while time.time() < deadline and _shm_used() > before:
        time.sleep(0.05)
    assert _shm_used() <= before


def test_put_del_frees_shm_tensor(rt_port):
    before = _shm_used()
    ref = rt.put(torch.zeros(1 << 20, dtype=torch.float32))  # 4 MB
    assert _shm_used() >= before + (1 << 22)
    del ref
    gc.collect()
    deadline = time.time() + 2   # async sweeper-batched free
    while time.time() < deadline and _shm_used() > before:
        time.sleep(0.05)
    assert _shm_used() <= before


def test_task_results_freed_when_refs_dropped(rt_port):
    @rt.remote
    def f(i):
        return i

    base = _store_size()
    for i in range(200):
        rt.get(f.remote(i))  # ref dropped every iteration
    gc.collect()
    time.sleep(0.2)
    # Without GC this grows by ~200.
    assert _store_size() - base < 20, _store_size() - base


def test_borrower_keeps_object_alive(rt_port):
    @rt.remote
    class Holder:
        def __init__(self):
            self.refs = None

        def hold(self, refs):
            self.refs = refs
            return True

        def read(self):
            return float(rt.get(self.refs[0]).sum())

        def drop(self):
            import gc as _gc

            self.refs = None
            _gc.collect()
            return True

    h = Holder.remote()
    ref = rt.put(np.ones(1 << 20, dtype=np.float32))
    # Nested so the ref itself travels by pickle (top-level args deref).
    assert rt.get(h.hold.remote([ref])) is True
    oid = ref.object_id
    del ref
    gc.collect()
    time.sleep(0.3)
    # Borrower still holds it: owner must NOT have freed the object.
    assert rt.get(h.read.remote()) == float(1 << 20)
    rt.get(h.drop.remote())
    gc.collect()
    deadline = time.time() + 10
    core = CoreWorker.current()
    try:
        while time.time() < deadline:
            if not core.memory_store.contains(oid) and \
                    not core.shm_store.contains(oid):
                break
            time.sleep(0.1)
        else:
            pytest.fail("object never freed after borrower dropped it")
    finally:
        rt.kill(h)  # release the actor's CPU for later tests


def test_nested_ref_survives_repeated_gets(rt_port):
    """Repeated deserialization of a container must not consume the
    container's borrow on its inner ref (each deserialized ref acquires
    and pays back its own borrow)."""
    inner = rt.put(np.arange(16.0))
    outer = rt.put({"inner": inner})
    oid = inner.object_id
    del inner
    gc.collect()
    core = CoreWorker.current()
    for _ in range(5):
        got = rt.get(outer)["inner"]
        assert float(rt.get(got).sum()) == float(np.arange(16.0).sum())
        del got
        gc.collect()
    time.sleep(0.3)
    # container alive → inner must still be alive
    assert core.memory_store.contains(oid) or core.shm_store.contains(oid)
    del outer
    gc.collect()
    deadline = time.time() + 10
    while time.time() < deadline:
        if not core.memory_store.contains(oid) and \
                not core.shm_store.contains(oid):
            return
        time.sleep(0.1)
    pytest.fail("inner object not freed after container died")


def test_promoted_arg_freed_after_submission(rt_port):
    """A big arg promoted to shm is kept alive for the task (incl. its
    retries) and released once the submission completes."""

    @rt.remote
    def total(a):
        return float(a.sum())

    before = _shm_used()
    assert rt.get(total.remote(np.ones(1 << 20, dtype=np.float32))) == float(
        1 << 20)
    gc.collect()
    deadline = time.time() + 10
    while time.time() < deadline:
        if _shm_used() <= before:
            return
        time.sleep(0.1)
    pytest.fail(f"promoted arg leaked: {_shm_used() - before} bytes")


def test_streaming_generator_streams_before_completion(rt_port):
    @rt.remote
    def slow_gen(n):
        for i in range(n):
            time.sleep(0.15)
            yield i * i

    t0 = time.time()
    gen = slow_gen.options(num_returns="streaming").remote(5)
    first_ref = next(gen)
    first_latency = time.time() - t0
    assert rt.get(first_ref) == 0
    # First item must arrive well before the full 0.75s of generation.
    assert first_latency < 0.6, first_latency
    rest = [rt.get(r) for r in gen]
    assert rest == [1, 4, 9, 16]


def test_streaming_generator_for_loop_and_error(rt_port):
    @rt.remote
    def bad_gen():
        yield 1
        yield 2
        raise ValueError("boom mid-stream")

    gen = bad_gen.options(num_returns="streaming").remote()
    values = []
    with pytest.raises(Exception, match="boom"):
        for ref in gen:
            values.append(rt.get(ref))
    assert values == [1, 2]


def test_actor_streaming_generator(rt_port):
    @rt.remote
    class Streamer:
        def stream(self, n):
            for i in range(n):
                yield {"i": i}

    s = Streamer.remote()
    try:
        gen = s.stream.options(num_returns="streaming").remote(4)
        out = [rt.get(r)["i"] for r in gen]
        assert out == [0, 1, 2, 3]
    finally:
        rt.kill(s)  # release the actor's CPU for later tests


def test_generator_drop_frees_items(rt_port):
    @rt.remote
    def gen(n):
        for i in range(n):
            yield np.zeros(1000)

    g = gen.options(num_returns="streaming").remote(10)
    next(g)
    time.sleep(1.0)  # let all items stream in
    base = _store_size()
    del g
    gc.collect()
    time.sleep(0.2)
    assert _store_size() < base, (base, _store_size())
