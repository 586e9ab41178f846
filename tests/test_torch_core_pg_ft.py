"""Placement groups + fault tolerance in the port's runtime: the cases
of ``test_core_pg_ft.py`` run against ``ray_tpu_torch``, one runtime for
the module (the reference's ``rt_fresh`` cases kill only their own
workers), with GPU requests beside the CPU ones
(reference: python/ray/tests/test_placement_group*.py, test_reconstruction*.py)."""
import time

import pytest

from torch_runtime import case_time_limit, rt_port  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_pg_create_ready(rt_port):
    rt = rt_port
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=15)
    rt.remove_placement_group(pg)


def test_pg_schedule_into_bundle(rt_port):
    rt = rt_port
    pg = rt.placement_group([{"CPU": 2}], strategy="PACK")
    pg.ready(timeout=15)

    @rt.remote
    def f():
        return "in-bundle"

    s = rt.PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=0)
    assert rt.get(f.options(scheduling_strategy=s).remote()) == "in-bundle"
    rt.remove_placement_group(pg)


def test_pg_actor_in_bundle(rt_port):
    rt = rt_port
    pg = rt.placement_group([{"CPU": 1}], strategy="PACK")
    pg.ready(timeout=15)

    @rt.remote
    class A:
        def ping(self):
            return 1

    s = rt.PlacementGroupSchedulingStrategy(pg)
    a = A.options(scheduling_strategy=s).remote()
    assert rt.get(a.ping.remote()) == 1
    rt.kill(a)
    rt.remove_placement_group(pg)


def test_gpu_requests_on_a_cpu_node(rt_port):
    """``num_gpus`` asks for the ``GPU`` resource: a bundle of one GPU is
    infeasible on a node with none, and a ``num_gpus=1`` task stays
    pending while ``num_gpus=0`` runs."""
    rt = rt_port
    pg = rt.placement_group([{"GPU": 1}], strategy="PACK")
    with pytest.raises(Exception):
        pg.ready(timeout=1.0)
    rt.remove_placement_group(pg)

    @rt.remote
    def where():
        return "ran"

    pending = where.options(num_gpus=1).remote()
    ready, _ = rt.wait([pending], timeout=1.0)
    assert ready == []
    assert rt.get(where.options(num_gpus=0).remote()) == "ran"


def test_pg_infeasible(rt_port):
    rt = rt_port
    pg = rt.placement_group([{"CPU": 1000}], strategy="PACK")
    with pytest.raises(Exception):
        pg.ready(timeout=1.0)


def test_pg_resources_returned_after_remove(rt_port):
    rt = rt_port
    before = rt.available_resources()["CPU"]
    pg = rt.placement_group([{"CPU": 4}])
    pg.ready(timeout=15)
    during = rt.available_resources()["CPU"]
    assert during <= before - 4
    rt.remove_placement_group(pg)
    time.sleep(0.2)
    after = rt.available_resources()["CPU"]
    assert after >= before - 0.01


def test_task_retry_on_worker_death(rt_port):
    rt = rt_port

    @rt.remote(max_retries=3)
    def flaky(marker_path):
        import os

        # Die the first time, succeed on retry (marker file persists).
        if not os.path.exists(marker_path):
            open(marker_path, "w").close()
            os._exit(1)
        return "recovered"

    import tempfile

    marker = tempfile.mktemp()
    assert rt.get(flaky.remote(marker), timeout=60) == "recovered"


def test_worker_crash_no_retry(rt_port):
    rt = rt_port

    @rt.remote(max_retries=0)
    def die():
        import os

        os._exit(1)

    with pytest.raises(Exception):
        rt.get(die.remote(), timeout=60)


def test_remove_racing_pending_create_wins(rt_port):
    """remove_placement_group on a still-PENDING (infeasible-for-now)
    create must win: the create loop aborts instead of committing a
    reservation nobody holds a handle to (leak)."""
    import time

    rt = rt_port
    # Infeasible for the 4-CPU fixture cluster: stays PENDING.
    pg = rt.placement_group([{"CPU": 64.0}], strategy="PACK")
    with pytest.raises(Exception):
        pg.ready(timeout=1.5)
    rt.remove_placement_group(pg)
    # Free capacity never lets the raced create come back to life.
    time.sleep(1.0)
    from ray_tpu_torch.core.worker import CoreWorker

    st = CoreWorker.current().head_call("pg_state", {"pg_id": pg._id.hex()})
    assert st["state"] == "REMOVED"
    listed = rt.state("placement_groups")
    assert all(p["pg_id"] != pg._id.hex() for p in listed)


def test_pg_state_unknown_id_grace_then_removed(rt_port):
    """pg_state answers PENDING only inside a short grace window for an
    id with no entry; a permanently-dead id then reads REMOVED so stale
    handles fail fast instead of burning their whole timeout."""
    import time

    from ray_tpu_torch._private.ids import PlacementGroupID
    from ray_tpu_torch.core.worker import CoreWorker

    ghost = PlacementGroupID.from_random().hex()
    core = CoreWorker.current()
    assert core.head_call("pg_state", {"pg_id": ghost})["state"] == "PENDING"
    deadline = time.time() + 30
    while time.time() < deadline:
        st = core.head_call("pg_state", {"pg_id": ghost})["state"]
        if st == "REMOVED":
            break
        time.sleep(0.5)
    assert st == "REMOVED"
