"""The port's multi-node runtime (``ray_tpu_torch.cluster_utils``): node
daemons, scheduling policies across nodes, cross-node objects, node
death, per-node dashboard agents and per-node serve proxies.

The reference's cases of ``test_multinode.py`` (all but the gang train
job, which is ``test_torch_gang.py::test_gang_train_job_across_nodes``),
``test_object_transfer.py``,
``test_object_recovery::test_multinode_node_death_objects_recovered``,
``test_node_agent::test_agents_through_head_and_direct`` and
``test_serve_proxy_fleet.py``, on the port: a head thread in the test
process and real node-daemon subprocesses
(``python -m ray_tpu_torch._private.node_main``), each on a synthetic
shm domain of its own, so cross-node objects take the TCP path and a
node kill is a process kill. Port-only: a node added with
``num_gpus=1`` advertises ``GPU`` and takes a ``num_gpus=1`` task with
no card (nothing in the task touches one).
"""
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_runtime import case_time_limit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CASE_LIMIT_S = 120.0


def _fresh_cluster(head_cpus=0.0, **kw):
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    if rt.is_initialized():
        rt.shutdown()
    return Cluster(head_resources={"CPU": head_cpus}, **kw)


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    # Node daemons and their workers inherit this (torch_runtime.py).
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture
def cluster2():
    """Head (0 CPU) + two 2-CPU nodes, driver connected."""
    c = _fresh_cluster()
    try:
        c.add_node(num_cpus=2)
        c.add_node(num_cpus=2)
        rt = c.connect()
        yield c, rt
    finally:
        c.shutdown()


@pytest.fixture
def two_node_cluster(monkeypatch):
    # Tiny chunks, so modest arrays exercise the chunk pipeline.
    monkeypatch.setenv("RT_TRANSFER_CHUNK_BYTES", str(256 * 1024))
    c = _fresh_cluster()
    try:
        n1 = c.add_node(num_cpus=2)
        n2 = c.add_node(num_cpus=2)
        c.connect()
        yield c, n1, n2
    finally:
        c.shutdown()


def _node_of():
    import ray_tpu_torch as rt

    @rt.remote
    def whereami():
        from ray_tpu_torch.core.worker import CoreWorker

        return CoreWorker.current().node_id

    return whereami


# ------------------------------------------------------ test_multinode.py


def test_shared_shm_domain_nodes_use_shm():
    """``add_node(shared_shm=True)``: co-hosted daemons join the
    session's shm domain, so a large object made on one node is read on
    the other through shared memory, not TCP."""
    c = _fresh_cluster()
    try:
        c.add_node(num_cpus=1, shared_shm=True)
        c.add_node(num_cpus=1, shared_shm=True)
        rt = c.connect()
        nodes = [n for n in c.list_nodes() if not n.get("is_head")]
        assert len({n["hostname"] for n in nodes}) == 1  # one domain
        n1, n2 = c._nodes
        strat = rt.NodeAffinitySchedulingStrategy

        @rt.remote
        def produce():
            return np.arange(1_000_000, dtype=np.int64)

        @rt.remote
        def consume(a):
            return int(a.sum())

        ref = produce.options(
            scheduling_strategy=strat(n1.node_id)).remote()
        assert rt.get(consume.options(
            scheduling_strategy=strat(n2.node_id)).remote(ref),
            timeout=60) == 499999500000
    finally:
        c.shutdown()


def test_node_label_scheduling():
    """NODE_LABEL: hard labels select, soft labels prefer, and an
    unsatisfiable hard selector fails the lease."""
    c = _fresh_cluster()
    try:
        c.add_node(num_cpus=2, labels={"zone": "a", "disk": "ssd"})
        c.add_node(num_cpus=2, labels={"zone": "b"})
        rt = c.connect()
        whereami = _node_of()
        strat = rt.NodeLabelSchedulingStrategy
        ssd, zb = c._nodes
        assert rt.get(whereami.options(scheduling_strategy=strat(
            hard={"disk": "ssd"})).remote()) == ssd.node_id
        assert rt.get(whereami.options(scheduling_strategy=strat(
            hard={"zone": "b"})).remote()) == zb.node_id
        # Soft-only: prefers the match but never blocks.
        assert rt.get(whereami.options(scheduling_strategy=strat(
            soft={"zone": "b"})).remote()) == zb.node_id
        with pytest.raises(Exception):
            rt.get(whereami.options(scheduling_strategy=strat(
                hard={"zone": "mars"})).remote(), timeout=10)
    finally:
        c.shutdown()


def test_spread_uses_both_nodes(cluster2):
    c, rt = cluster2
    whereami = _node_of()
    ids = rt.get([whereami.options(scheduling_strategy="SPREAD").remote()
                  for _ in range(8)])
    assert len({x for x in ids if x}) == 2, ids


def test_node_affinity_hard_and_soft(cluster2):
    c, rt = cluster2
    n1, n2 = c._nodes
    whereami = _node_of()
    strat = rt.NodeAffinitySchedulingStrategy
    assert rt.get(whereami.options(
        scheduling_strategy=strat(n1.node_id)).remote()) == n1.node_id
    assert rt.get(whereami.options(
        scheduling_strategy=strat(n2.node_id)).remote()) == n2.node_id
    assert rt.get(whereami.options(
        scheduling_strategy=strat(n2.node_id, soft=True)).remote()) == \
        n2.node_id


def test_cross_node_object_transfer(cluster2):
    """A 4 MB array made on node 1 is read on node 2 and by the driver:
    across shm domains the bytes go over TCP."""
    c, rt = cluster2
    n1, n2 = c._nodes
    strat = rt.NodeAffinitySchedulingStrategy

    @rt.remote
    def make():
        return np.arange(1 << 20, dtype=np.float32)

    @rt.remote
    def consume(a):
        return float(a.sum())

    ref = make.options(scheduling_strategy=strat(n1.node_id)).remote()
    expected = float(np.arange(1 << 20, dtype=np.float32).sum())
    assert rt.get(consume.options(
        scheduling_strategy=strat(n2.node_id)).remote(ref)) == expected
    assert float(rt.get(ref).sum()) == expected


def test_cross_node_tensor_and_driver_put(cluster2):
    """Port-only: a torch tensor crosses nodes bit for bit both ways, and
    an object the driver put is pulled by a node's worker over TCP."""
    import torch

    c, rt = cluster2
    n1, n2 = c._nodes
    strat = rt.NodeAffinitySchedulingStrategy
    t = torch.randn(1 << 19, generator=torch.Generator().manual_seed(0))
    t = t.to(torch.bfloat16)

    @rt.remote
    def bits(x):
        import torch

        return int(x.view(torch.int16).long().sum()), str(x.dtype)

    @rt.remote
    def double(x):
        return x * 2

    want = int(t.view(torch.int16).long().sum())
    assert rt.get(bits.options(scheduling_strategy=strat(
        n1.node_id)).remote(rt.put(t)), timeout=60) == (want,
                                                        "torch.bfloat16")
    made = double.options(scheduling_strategy=strat(n1.node_id)).remote(t)
    assert rt.get(bits.options(scheduling_strategy=strat(
        n2.node_id)).remote(made), timeout=60)[0] == int(
        (t * 2).view(torch.int16).long().sum())
    assert torch.equal(rt.get(made).view(torch.int16),
                       (t * 2).view(torch.int16))


def test_strict_spread_placement_group(cluster2):
    c, rt = cluster2
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}],
                            strategy="STRICT_SPREAD")
    pg.ready(timeout=30)
    whereami = _node_of()
    homes = rt.get([whereami.options(
        scheduling_strategy=rt.PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=i)).remote()
        for i in range(2)])
    assert homes[0] != homes[1], homes
    rt.remove_placement_group(pg)


def test_strict_spread_infeasible_with_one_node():
    """STRICT_SPREAD with more bundles than nodes fails, not degrades."""
    c = _fresh_cluster()
    try:
        c.add_node(num_cpus=4)
        rt = c.connect()
        pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}],
                                strategy="STRICT_SPREAD")
        with pytest.raises(Exception):
            pg.ready(timeout=3)
    finally:
        c.shutdown()


def test_strict_pack_stays_on_one_node(cluster2):
    c, rt = cluster2
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
    pg.ready(timeout=30)
    whereami = _node_of()
    homes = rt.get([whereami.options(
        scheduling_strategy=rt.PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=i)).remote()
        for i in range(2)])
    assert homes[0] == homes[1], homes
    rt.remove_placement_group(pg)


def test_actor_restarts_on_surviving_node(cluster2):
    c, rt = cluster2
    n1, n2 = c._nodes
    strat = rt.NodeAffinitySchedulingStrategy

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def node(self):
            from ray_tpu_torch.core.worker import CoreWorker

            return CoreWorker.current().node_id

    a = Counter.options(
        max_restarts=2,
        scheduling_strategy=strat(n2.node_id, soft=True)).remote()
    assert rt.get(a.incr.remote()) == 1
    home = rt.get(a.node.remote())
    assert home == n2.node_id

    c.remove_node(n2, graceful=False)
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            new_home = rt.get(a.node.remote(), timeout=10)
            if new_home and new_home != home:
                break
        except Exception:  # noqa: BLE001 - still restarting
            time.sleep(0.2)
    else:
        pytest.fail("actor never restarted on the surviving node")
    assert new_home == n1.node_id
    # A fresh instance (state lost), but the handle keeps working.
    assert rt.get(a.incr.remote()) >= 1


def test_node_death_replaces_pg_bundle(cluster2):
    """A bundle on a dead node is placed again on a surviving node."""
    c, rt = cluster2
    n1, n2 = c._nodes
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="SPREAD")
    pg.ready(timeout=30)
    c.remove_node(n2, graceful=False)
    deadline = time.time() + 30
    whereami = _node_of()
    while time.time() < deadline:
        try:
            homes = rt.get([whereami.options(
                scheduling_strategy=rt.PlacementGroupSchedulingStrategy(
                    pg, placement_group_bundle_index=i)).remote()
                for i in range(2)], timeout=15)
            assert all(h == n1.node_id for h in homes), homes
            break
        except AssertionError:
            raise
        except Exception:  # noqa: BLE001 - bundle still being re-placed
            time.sleep(0.3)
    else:
        pytest.fail("PG bundle was never re-placed after node death")
    rt.remove_placement_group(pg)


def test_gpu_node_takes_gpu_task():
    """Port-only: ``add_node(num_gpus=1)`` advertises ``GPU`` on that
    node alone, and a ``num_gpus=1`` task (which touches no card) runs
    there while the CPU-only node takes none."""
    c = _fresh_cluster()
    try:
        cpu_node = c.add_node(num_cpus=2)
        gpu_node = c.add_node(num_cpus=1, num_gpus=1)
        rt = c.connect()
        assert rt.cluster_resources()["GPU"] == 1.0
        by_id = {n["node_id"]: n for n in c.list_nodes()}
        assert by_id[gpu_node.node_id]["total"]["GPU"] == 1.0
        assert "GPU" not in by_id[cpu_node.node_id]["total"]
        whereami = _node_of()
        homes = rt.get([whereami.options(num_gpus=1).remote()
                        for _ in range(3)], timeout=60)
        assert homes == [gpu_node.node_id] * 3
        # The driver keeps an idle worker's lease a moment before it
        # gives the card back.
        deadline = time.time() + 15
        while rt.available_resources().get("GPU") != 1.0 and \
                time.time() < deadline:
            time.sleep(0.2)
        assert rt.available_resources()["GPU"] == 1.0
    finally:
        c.shutdown()


# ------------------------------------------------- test_object_transfer.py


def test_shm_domains_isolate():
    """A segment made in one domain cannot be attached from another:
    synthetic nodes model hosts."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import SharedMemoryStore

    a = SharedMemoryStore(1 << 24, domain=f"hostA-{os.getpid()}")
    b = SharedMemoryStore(1 << 24, domain=f"hostB-{os.getpid()}")
    oid = ObjectID.from_random()
    a.create(oid, [b"h", b"x" * 1024])
    assert a.get(oid) is not None
    assert b.get(oid) is None
    a.delete(oid)


def test_create_clobbers_stale_pending_segment():
    """A producer's create overwrites a half-written (count-0) leftover
    segment instead of taking it for an existing copy."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import SharedMemoryStore

    dom = f"clobber-{os.getpid()}-{int(time.time())}"
    store = SharedMemoryStore(1 << 24, domain=dom)
    reader = SharedMemoryStore(1 << 24, domain=dom)
    oid = ObjectID.from_random()
    view = store.create_pending(oid, [3, 3])
    assert view is not None
    assert reader.get(oid) is None
    assert store.create_pending(oid, [64]) is None
    store2 = SharedMemoryStore(1 << 24, domain=dom)
    store2.create(oid, [b"hdr", b"body"])
    # The loser's abort must not unlink the successor's complete copy.
    store.abort_pending(oid)
    got = reader.get(oid)
    assert got is not None and bytes(got[1]) == b"body"
    store2.delete(oid)


def test_pending_seal_publishes():
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import SharedMemoryStore

    dom = f"seal-{os.getpid()}-{int(time.time())}"
    store = SharedMemoryStore(1 << 24, domain=dom)
    reader = SharedMemoryStore(1 << 24, domain=dom)
    oid = ObjectID.from_random()
    frames = [b"h", b"payload-bytes"]
    view = store.create_pending(oid, [len(f) for f in frames])
    off = 0
    for f in frames:
        view[off:off + len(f)] = f
        off += len(f)
    assert reader.get(oid) is None  # count still 0
    store.seal(oid)
    got = reader.get(oid)
    assert got is not None and bytes(got[1]) == b"payload-bytes"
    store.delete(oid)


def test_pending_ttl_sweep_reclaims_crashed_puller():
    """A puller that dies between ``create_pending`` and seal/abort does
    not pin its reserved bytes or the segment's name: the TTL sweep
    aborts the orphan."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import SharedMemoryStore

    dom = f"pend-ttl-{os.getpid()}-{int(time.time())}"
    store = SharedMemoryStore(1 << 24, domain=dom)
    oid = ObjectID.from_random()
    frames = [b"h", b"x" * 4096]
    view = store.create_pending(oid, [len(f) for f in frames])
    assert view is not None
    assert store.used_bytes() > 0 and store.pending_count() == 1
    assert store.sweep_pending() == 0
    assert store.pending_count() == 1
    assert store.sweep_pending(
        now=time.monotonic() + store.PENDING_TTL_S + 1) == 1
    assert store.pending_count() == 0
    assert store.used_bytes() == 0, "reserved bytes leaked"
    del view
    view2 = store.create_pending(oid, [len(f) for f in frames])
    assert view2 is not None, "swept segment still squats the name"
    off = 0
    for f in frames:
        view2[off:off + len(f)] = f
        off += len(f)
    store.seal(oid)
    got = store.get(oid)
    assert got is not None and bytes(got[1]) == frames[1]
    store.delete(oid)
    # An expired orphan is reclaimed by the next create_pending.
    oid2, oid3 = ObjectID.from_random(), ObjectID.from_random()
    assert store.create_pending(oid2, [1, 16]) is not None
    store._pending[oid2] = store._pending[oid2][:3] + (
        time.monotonic() - store.PENDING_TTL_S - 1,)
    assert store.create_pending(oid3, [1, 16]) is not None
    assert store.pending_count() == 1          # oid2 swept, oid3 live
    store.abort_pending(oid3)
    # A slow puller whose reservation was swept gets a typed error at
    # seal, and never publishes a retrying writer's segment.
    oid4 = ObjectID.from_random()
    stale_view = store.create_pending(oid4, [1, 16])
    assert store.sweep_pending(now=time.monotonic()
                               + store.PENDING_TTL_S + 1) == 1
    with pytest.raises(RuntimeError, match="swept"):
        store.seal(oid4, view=stale_view)
    fresh_view = store.create_pending(oid4, [1, 16])
    assert fresh_view is not None
    with pytest.raises(RuntimeError, match="another writer"):
        store.seal(oid4, view=stale_view)
    store.abort_pending(oid4, view=stale_view)   # guarded no-op
    assert store.pending_count() == 1
    fresh_view[:] = b"h" + b"y" * 16
    store.seal(oid4, view=fresh_view)
    got4 = store.get(oid4)
    assert got4 is not None and bytes(got4[1]) == b"y" * 16
    store.delete(oid4)


def test_concurrent_same_ref_pulls(two_node_cluster):
    """Six tasks on one node read the same remote ref: every one gets
    the value."""
    import ray_tpu_torch as rt

    cluster, n1, n2 = two_node_cluster

    @rt.remote
    def produce():
        return np.full(1 << 19, 3.0, dtype=np.float32)

    @rt.remote
    def consume(x, _i):
        return float(x[0])

    r = produce.options(scheduling_strategy=rt.NodeAffinitySchedulingStrategy(
        node_id=n1.node_id, soft=False)).remote()
    outs = [consume.options(
        scheduling_strategy=rt.NodeAffinitySchedulingStrategy(
            node_id=n2.node_id, soft=False)).remote(r, i) for i in range(6)]
    assert rt.get(outs, timeout=120) == [3.0] * 6


def test_cross_node_chunked_pull(two_node_cluster):
    """A 2 MB array (8 chunks of 256 KiB) made on node 1 and read on
    node 2: only the chunk protocol can move it."""
    import ray_tpu_torch as rt

    cluster, n1, n2 = two_node_cluster

    @rt.remote
    def produce():
        return np.arange(1 << 19, dtype=np.float32)

    @rt.remote
    def consume(x):
        return float(x.sum())

    r = produce.options(scheduling_strategy=rt.NodeAffinitySchedulingStrategy(
        node_id=n1.node_id, soft=False)).remote()
    out = consume.options(scheduling_strategy=rt.NodeAffinitySchedulingStrategy(
        node_id=n2.node_id, soft=False)).remote(r)
    assert rt.get(out, timeout=120) == float(
        np.arange(1 << 19, dtype=np.float32).sum())


def test_pullers_register_as_copies(two_node_cluster):
    """After a cross-node pull the head's object directory lists the
    puller as another copy."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.worker import CoreWorker

    cluster, n1, n2 = two_node_cluster

    @rt.remote
    def produce():
        return np.ones(1 << 19, dtype=np.float32)

    @rt.remote
    def consume(x):
        return float(x[0])

    r = produce.options(scheduling_strategy=rt.NodeAffinitySchedulingStrategy(
        node_id=n1.node_id, soft=False)).remote()
    assert rt.get(consume.options(
        scheduling_strategy=rt.NodeAffinitySchedulingStrategy(
            node_id=n2.node_id, soft=False)).remote(r), timeout=120) == 1.0
    core = CoreWorker._current
    locs = core.run_sync(core._head.call_simple(
        "object_loc_get", {"object_id": r.object_id.hex()}))["locations"]
    assert len(locs) >= 2, locs   # producer + puller
    assert len({loc["domain"] for loc in locs}) >= 2, locs


# ------------------------------------------------- test_object_recovery.py


def test_multinode_node_death_objects_recovered():
    """Kill the node whose shm domain holds objects a consumer still
    needs: the owner runs the producing tasks again elsewhere."""
    import ray_tpu_torch as rt

    cluster = _fresh_cluster()
    try:
        n1 = cluster.add_node(num_cpus=4)
        cluster.connect()

        @rt.remote
        def produce(i):
            return np.full(1 << 19, i, dtype=np.float32)

        @rt.remote
        def consume(x):
            return float(x[0])

        refs = [produce.remote(i) for i in range(4)]
        assert rt.get([consume.remote(r) for r in refs],
                      timeout=60) == [0.0, 1.0, 2.0, 3.0]
        cluster.add_node(num_cpus=4)
        cluster.remove_node(n1)  # the producing node (and its shm) dies
        out = rt.get([consume.remote(r) for r in refs], timeout=120)
        assert out == [0.0, 1.0, 2.0, 3.0]
    finally:
        cluster.shutdown()


# ----------------------------------------------------- test_node_agent.py


def _fetch(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def test_agents_through_head_and_direct(monkeypatch):
    # Direct agent access is opt-in: bind the routable interface.
    monkeypatch.setenv("RT_AGENT_BIND", "0.0.0.0")
    c = _fresh_cluster()
    try:
        c.add_node(num_cpus=2)
        rt = c.connect()

        @rt.remote
        def hello():
            print("agent-test-marker")
            return "hi"

        assert rt.get(hello.remote(), timeout=60) == "hi"
        dash = rt.dashboard_url()
        nodes = _fetch(f"{dash}/api/state?kind=nodes")
        remote = [n for n in nodes if not n["is_head"]]
        assert len(remote) == 1
        node = remote[0]
        assert node["agent_url"] and node["agent_url"].startswith("http")
        # 1) the head proxies the remote node's stats
        stats = _fetch(f"{dash}/api/node?node_id={node['node_id']}")
        assert stats["node_id"] == node["node_id"]
        assert stats["mem_total_bytes"] > 0
        assert stats["num_workers"] >= 1
        assert any(w.get("rss_bytes", 0) > 0 for w in stats["workers"])
        # 2) the head's own node answers too
        head_node = [n for n in nodes if n["is_head"]][0]
        hstats = _fetch(f"{dash}/api/node?node_id={head_node['node_id']}")
        assert hstats["node_id"] == head_node["node_id"]
        # 3) direct agent access
        astats = _fetch(f"{node['agent_url']}/api/stats")
        assert astats["node_id"] == node["node_id"]
        workers = _fetch(f"{node['agent_url']}/api/workers")
        assert len(workers) >= 1
        files = _fetch(f"{node['agent_url']}/api/logs")["files"]
        assert any(f.startswith("worker-") for f in files)
        # the worker that ran hello() is the one whose log has the marker
        logs = [_fetch(f"{node['agent_url']}/api/logs?worker_id="
                       f"{w['worker_id']}") for w in workers]
        assert all("data" in t for t in logs)
        wid = next(w["worker_id"] for w, t in zip(workers, logs)
                   if "agent-test-marker" in t["data"])
        # 4) the remote worker's log through the head URL
        log = _fetch(f"{dash}/api/logs?worker_id={wid}")
        assert "agent-test-marker" in log["data"]
        with pytest.raises(urllib.error.HTTPError):
            _fetch(f"{dash}/api/node?node_id=deadbeef")
    finally:
        c.shutdown()


# ---------------------------------------------- test_serve_proxy_fleet.py


def test_proxy_per_node_and_locality():
    """One serve proxy per node, reconciled by the controller; replicas
    spread over nodes; a handle prefers a replica on its own node; a
    dead node's proxy leaves the fleet while the other serves on."""
    c = _fresh_cluster(head_cpus=4)
    try:
        rt = c.connect()
        c.add_node(num_cpus=4, shared_shm=True)
        c.wait_for_nodes(2)
        from ray_tpu_torch import serve
        from ray_tpu_torch.core.worker import CoreWorker
        from ray_tpu_torch.serve.handle import get_router

        serve.start(http_options={"host": "127.0.0.1", "port": 0})

        @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 1})
        class Echo:
            def __call__(self, req):
                return {"msg": "hi"}

        serve.run(Echo.bind(), name="app", route_prefix="/echo")
        ctrl = serve.api._controller()
        deadline = time.time() + 30
        proxies = {}
        while time.time() < deadline:
            proxies = rt.get(ctrl.get_proxies.remote(), timeout=10)
            if len(proxies) >= 2:
                break
            time.sleep(0.2)
        assert len(proxies) == 2, proxies
        assert "SERVE_PROXY" in {p["name"] for p in proxies.values()}
        for p in proxies.values():
            info = p["info"]
            assert _fetch(f"http://{info['host']}:{info['port']}/echo") == \
                {"msg": "hi"}
        info = rt.get(ctrl.get_replicas.remote("app", "Echo"), timeout=10)
        nodes = set(info["replica_nodes"].values())
        assert len(info["replica_nodes"]) == 2
        assert None not in nodes
        assert len(nodes) == 2, f"replicas not spread: {info}"
        router = get_router("app", "Echo")
        router.refresh(force=True)
        # A driver attached over the head's socket has no node id of its
        # own (as in the reference); it runs on the head's host, so the
        # router is told that node, and must then pick only its replica.
        assert router._local_node == CoreWorker._current.node_id
        if router._local_node is None:
            router._local_node = next(n["node_id"] for n in c.list_nodes()
                                      if n["is_head"])
        local_node = router._local_node
        picked = {router._pick_locked() for _ in range(16)}
        local_rids = {rid for rid, nid in router._replica_nodes.items()
                      if nid == local_node}
        assert local_rids, router._replica_nodes   # one replica a node
        assert picked <= local_rids, (picked, router._replica_nodes)
        victim = c._nodes[0]
        dead_node = victim.node_id
        c.remove_node(victim, graceful=False)
        deadline = time.time() + 30
        while time.time() < deadline:
            proxies = rt.get(ctrl.get_proxies.remote(), timeout=10)
            if dead_node not in proxies and len(proxies) == 1:
                break
            time.sleep(0.2)
        assert dead_node not in proxies, proxies
        survivor = next(iter(proxies.values()))["info"]
        assert _fetch(f"http://{survivor['host']}:{survivor['port']}/echo") \
            == {"msg": "hi"}
    finally:
        try:
            from ray_tpu_torch import serve

            serve.shutdown()
        except Exception:  # noqa: BLE001
            pass
        c.shutdown()
