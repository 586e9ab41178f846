"""GPU gangs in the port: the topology half of
``_private/accelerators.py``, ``ScalingConfig(topology=...)``, the slice
half of ``autoscaler.py`` (``GPUSliceProvider``, the slice backends, the
GCE connectors over ``LocalGCEAPIServer`` on loopback) and a train gang
across nodes.

The counterparts of ``test_tpu_gang.py`` (topologies through both
packages' ``parse_topology``/``normalize_pod_type`` where their forms
match, the ``GPU-{gang}-head`` anchor, bundles, mixed gangs refused),
``test_gce_http.py`` (and each package's connector against the other's
server), ``test_ha_autoscaler::test_tpu_slice_provider_gang_scale`` and
``test_multinode::test_gang_train_job_across_nodes``. Every cluster here
is node-daemon subprocesses of ``cluster_utils`` on this host; a node's
``GPU`` is advertised with no card behind it.
"""
import threading
import time

import pytest

from ray_tpu_torch._private import accelerators as acc
from ray_tpu_torch.autoscaler import (FakeGCEConnector, GCEConnector,
                                      GCESliceBackend, HTTPGCEConnector,
                                      LocalGCEAPIServer)
from ray_tpu_torch.train.config import ScalingConfig
from torch_runtime import case_time_limit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CASE_LIMIT_S = 150.0


@pytest.fixture
def one_thread_daemons(monkeypatch):
    # Node daemons and their workers inherit this (torch_runtime.py).
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _fresh_cluster(**kw):
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    if rt.is_initialized():
        rt.shutdown()
    return Cluster(**kw)


# ------------------------------------------------------ test_tpu_gang.py
@pytest.mark.parametrize("raw", ["v4-8", "v5e-16", "h100-16", "a100-8",
                                 "h100-1024", "v5e", "h100", "h100-x",
                                 "h100-"])
def test_topologies_match_reference(raw):
    """Names both packages spell alike normalise and parse alike, and
    malformed ones are refused by both."""
    from ray_tpu._private import accelerators as ref

    def parse(mod):
        try:
            return mod.normalize_pod_type(raw), mod.parse_topology(raw)
        except ValueError as e:
            return "malformed" in str(e)

    assert parse(acc) == parse(ref)


def test_gpu_topology_names():
    assert acc.normalize_pod_type("NVIDIA-H100-16") == "h100-16"
    assert acc.parse_topology("nvidia-h100-16") == ("h100", 16)
    assert acc.head_resource_name("H100-16") == "GPU-h100-16-head"
    with pytest.raises(ValueError, match="malformed GPU topology"):
        acc.parse_topology("h100")


def test_hosts_per_gang(monkeypatch):
    monkeypatch.delenv("RT_GPU_CARDS_PER_HOST", raising=False)
    assert acc.num_hosts("h100-16") == 2 and acc.num_hosts("h100-4") == 1
    monkeypatch.setenv("RT_GPU_CARDS_PER_HOST", "4")
    assert acc.num_hosts("h100-16") == 4


def test_gang_resources_head_anchor(monkeypatch):
    monkeypatch.setenv("RT_GPU_TOPOLOGY", "nvidia-h100-16")
    monkeypatch.setenv("RT_GPU_WORKER_ID", "0")
    res = acc.gang_resources(8)
    assert res == {"GPU-h100-16-head": 1.0, "accelerator_type:H100": 8.0}
    monkeypatch.setenv("RT_GPU_WORKER_ID", "1")
    assert acc.gang_resources(8) == {"accelerator_type:H100": 8.0}
    monkeypatch.delenv("RT_GPU_TOPOLOGY")
    # outside a gang: the model label alone (given here; detected else)
    assert acc.gang_resources(8, "H100") == {"accelerator_type:H100": 8.0}
    assert acc.gang_resources(0, "H100") == {}
    # a provisioner mints host 0's shape explicitly
    assert acc.gang_resources(8, pod_type="h100-16", worker_id=0) == \
        {"GPU-h100-16-head": 1.0, "accelerator_type:H100": 8.0}


def test_scaling_config_topology_bundles_match_reference():
    """The port's gang bundles are the reference's with GPU for TPU."""
    from ray_tpu.train.config import ScalingConfig as RefScalingConfig

    sc = ScalingConfig(num_workers=4, use_gpu=True, gpus_per_worker=4,
                       topology="h100-16")
    ref = RefScalingConfig(num_workers=4, use_tpu=True, tpus_per_worker=4,
                           topology="v5e-16")
    as_ref = [{k.replace("GPU-h100-16", "TPU-v5e-16").replace("GPU", "TPU"):
               v for k, v in b.items()} for b in sc.bundles()]
    assert as_ref == ref.bundles()
    assert sc.bundles()[0]["GPU-h100-16-head"] == 1.0
    assert all("GPU-h100-16-head" not in b for b in sc.bundles()[1:])
    assert sc.effective_placement_strategy == \
        ref.effective_placement_strategy == "STRICT_PACK"
    assert sc.worker_resources == {"CPU": 1.0, "GPU": 4.0}
    assert ScalingConfig(num_workers=2, use_gpu=True).worker_resources == \
        {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(num_workers=2, use_gpu=True, gpus_per_worker=0.5
                         ).worker_resources["GPU"] == 0.5
    with pytest.raises(ValueError, match="16 cards"):
        ScalingConfig(num_workers=2, use_gpu=True, gpus_per_worker=4,
                      topology="h100-16").bundles()


def test_gang_placement_refuses_mixed_slices(one_thread_daemons):
    """Two single-host gangs: a gang anchored to one places on that
    gang's node, and a STRICT_PACK gang needing more cards than the
    anchored node has cannot borrow the other gang's."""
    cluster = _fresh_cluster(head_resources={"CPU": 0.0})
    try:
        cluster.add_node(num_cpus=4, num_gpus=4,
                         resources={"GPU-h100-8-head": 1.0})
        cluster.add_node(num_cpus=4, num_gpus=4,
                         resources={"GPU-h100-16-head": 1.0})
        rt = cluster.connect()
        pg = rt.placement_group(
            [{"CPU": 1.0, "GPU": 4.0, "GPU-h100-8-head": 1.0}],
            strategy="STRICT_PACK")
        pg.ready(timeout=30)
        bad = rt.placement_group(
            [{"GPU": 4.0, "GPU-h100-8-head": 1.0}, {"GPU": 8.0}],
            strategy="STRICT_PACK")
        with pytest.raises(Exception, match="not ready"):
            bad.ready(timeout=3)
        rt.remove_placement_group(bad)
        rt.remove_placement_group(pg)
    finally:
        cluster.shutdown()


# ----------------------------------------------------- test_gce_http.py
PARENT = "projects/p1/locations/us-central2-b"
BODY = {"tpu": {"node_spec": [{
    "parent": PARENT, "node_id": "qr-a",
    "node": {"accelerator_type": "h100-16",
             "runtime_version": "ubuntu2204-cuda"}}]}}


@pytest.fixture()
def served_fake():
    fake = FakeGCEConnector(polls_per_state=1)
    with LocalGCEAPIServer(fake) as srv:
        yield fake, HTTPGCEConnector(srv.endpoint, retry_base_s=0.01)


def test_http_lifecycle_states(served_fake):
    fake, conn = served_fake
    op = conn.create_queued_resource(PARENT, "qr-a", BODY)
    assert op["name"].endswith("op-qr-a") and op["done"] is False
    name = f"{PARENT}/queuedResources/qr-a"
    states = [conn.get_queued_resource(name)["state"]["state"]
              for _ in range(5)]
    assert states[:4] == ["CREATING", "WAITING_FOR_RESOURCES",
                          "PROVISIONING", "ACTIVE"]
    assert conn.delete_queued_resource(name)["done"] is True
    assert [r[0] for r in fake.requests] == \
        ["create"] + ["get"] * 5 + ["delete"]


def test_http_error_mapping(served_fake):
    _, conn = served_fake
    with pytest.raises(KeyError, match="not found"):
        conn.get_queued_resource(f"{PARENT}/queuedResources/ghost")
    with pytest.raises(ValueError, match="node_spec"):
        conn.create_queued_resource(PARENT, "bad", {"tpu": {}})
    with pytest.raises(ValueError, match="queuedResourceId"):
        conn._request("POST", f"/v2/{PARENT}/queuedResources", {})


def test_http_bearer_auth():
    fake = FakeGCEConnector()
    with LocalGCEAPIServer(fake, require_token="s3cret") as srv:
        noauth = HTTPGCEConnector(srv.endpoint, retry_base_s=0.01)
        with pytest.raises(PermissionError, match="bearer"):
            noauth.get_queued_resource(f"{PARENT}/queuedResources/x")
        authed = HTTPGCEConnector(srv.endpoint, retry_base_s=0.01,
                                  token_provider=lambda: "s3cret")
        authed.create_queued_resource(PARENT, "qr-a", BODY)
        assert fake.requests[-1][0] == "create"


def test_http_retries_transient_500():
    """The first two GETs fail as 500s; the connector retries through to
    the fake's real answer."""
    fake = FakeGCEConnector()
    fail_left = [2]

    class Flaky(GCEConnector):
        def create_queued_resource(self, parent, qr_id, body):
            return fake.create_queued_resource(parent, qr_id, body)

        def get_queued_resource(self, name):
            if fail_left[0] > 0:
                fail_left[0] -= 1
                raise RuntimeError("upstream hiccup")  # -> 500
            return fake.get_queued_resource(name)

        def delete_queued_resource(self, name):
            return fake.delete_queued_resource(name)

    with LocalGCEAPIServer(Flaky()) as srv:
        conn = HTTPGCEConnector(srv.endpoint, retry_base_s=0.01)
        conn.create_queued_resource(PARENT, "qr-a", BODY)
        doc = conn.get_queued_resource(f"{PARENT}/queuedResources/qr-a")
        assert doc["state"]["state"] == "CREATING" and fail_left[0] == 0


def test_create_replay_is_idempotent(served_fake):
    fake, conn = served_fake
    op1 = conn.create_queued_resource(PARENT, "qr-a", BODY)
    op2 = conn.create_queued_resource(PARENT, "qr-a", BODY)  # replay
    assert op2["name"] == op1["name"] and op2["done"] is False
    assert len(fake.resources) == 1


def test_http_unreachable_raises_connection_error():
    conn = HTTPGCEConnector("http://127.0.0.1:1", max_retries=1,
                            retry_base_s=0.01)
    with pytest.raises(ConnectionError, match="unreachable"):
        conn.get_queued_resource(f"{PARENT}/queuedResources/x")


def test_slice_backend_over_http():
    """``GCESliceBackend`` through the HTTP transport: a 2-host h100-16
    gang is one queued resource naming the gang as its accelerator
    type, polled to ACTIVE, deleted once."""
    fake = FakeGCEConnector(polls_per_state=1)
    with LocalGCEAPIServer(fake, require_token="tok") as srv:
        conn = HTTPGCEConnector(srv.endpoint, retry_base_s=0.01,
                                token_provider=lambda: "tok")
        backend = GCESliceBackend(conn, "NVIDIA-H100-16", project="p1",
                                  poll_interval_s=0.01)
        handles = [backend.launch("slice-0", w, {}, 4, 8)
                   for w in range(acc.num_hosts("h100-16"))]
        backend.finalize("slice-0", handles)
        for h in handles:
            backend.terminate(h)
    verbs = [r[0] for r in fake.requests]
    assert verbs.count("create") == 1 and verbs.count("delete") == 1
    assert fake.requests[0][3]["tpu"]["node_spec"][0]["node"][
        "accelerator_type"] == "h100-16"


def test_concurrent_http_clients():
    fake = FakeGCEConnector(polls_per_state=1)
    errors = []
    with LocalGCEAPIServer(fake) as srv:
        def worker(i):
            try:
                conn = HTTPGCEConnector(srv.endpoint, retry_base_s=0.01)
                body = {"tpu": {"node_spec": [{
                    "parent": PARENT, "node_id": f"qr-{i}",
                    "node": {"accelerator_type": "h100-16",
                             "runtime_version": "v2"}}]}}
                conn.create_queued_resource(PARENT, f"qr-{i}", body)
                name = f"{PARENT}/queuedResources/qr-{i}"
                for _ in range(4):
                    conn.get_queued_resource(name)
                assert conn.get_queued_resource(
                    name)["state"]["state"] == "ACTIVE"
            except Exception as e:
                errors.append((i, e))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors
    assert len(fake.resources) == 8


@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_connectors_cross_packages(server_pkg):
    """Each package's HTTP connector drives the other's server through a
    lifecycle with the same answers: the REST shape is one."""
    from ray_tpu import autoscaler as ref

    srv_mod, cli_mod = ((ref, __import__("ray_tpu_torch.autoscaler",
                                         fromlist=["x"]))
                        if server_pkg == "reference" else
                        (__import__("ray_tpu_torch.autoscaler",
                                    fromlist=["x"]), ref))
    fake = srv_mod.FakeGCEConnector(polls_per_state=1)
    with srv_mod.LocalGCEAPIServer(fake) as srv:
        conn = cli_mod.HTTPGCEConnector(srv.endpoint, retry_base_s=0.01)
        conn.create_queued_resource(PARENT, "qr-a", BODY)
        name = f"{PARENT}/queuedResources/qr-a"
        states = [conn.get_queued_resource(name)["state"]["state"]
                  for _ in range(4)]
        with pytest.raises(KeyError):
            conn.get_queued_resource(f"{PARENT}/queuedResources/ghost")
        assert conn.delete_queued_resource(name)["done"] is True
    assert states == ["CREATING", "WAITING_FOR_RESOURCES", "PROVISIONING",
                      "ACTIVE"]


# ------------------------------------------- the slice provider and a gang
def test_gpu_slice_provider_gang_scale(one_thread_daemons, monkeypatch):
    """GPU demand launches a WHOLE gang (2 hosts of 8 cards for
    h100-16), CPU demand launches nothing, and an idle gang retires
    atomically."""
    from ray_tpu_torch.autoscaler import Autoscaler, GPUSliceProvider

    monkeypatch.delenv("RT_GPU_CARDS_PER_HOST", raising=False)
    cluster = _fresh_cluster(head_resources={"CPU": 4.0},
                             system_config={"worker_lease_timeout_s": 120.0})
    rt = cluster.connect()
    provider = GPUSliceProvider(cluster, pod_type="h100-16")
    assert provider.hosts_per_slice == 2 and provider.cards_per_host == 8
    # capacity-aware demand: 2 asks of 8 cards = ONE h100-16 gang
    assert provider.slices_needed(
        {"pending_resource_shapes": [{"GPU": 8.0}, {"GPU": 8.0}]}) == 1
    assert provider.slices_needed(
        {"pending_resource_shapes": [{"CPU": 1.0},
                                     {"GPU-h100-16-head": 1.0}]}) == 1
    scaler = Autoscaler(provider, min_nodes=0, max_nodes=2,
                        idle_timeout_s=3.0, poll_period_s=0.5,
                        demand_fn=provider.slices_needed).start()
    try:
        @rt.remote
        def cpu_work():
            return "cpu"

        assert rt.get(cpu_work.remote(), timeout=30) == "cpu"
        time.sleep(1.5)
        assert provider.non_terminated_nodes() == []

        @rt.remote(num_gpus=8)
        def gpu_work():
            return "gpu"

        assert rt.get([gpu_work.remote() for _ in range(2)],
                      timeout=120) == ["gpu", "gpu"]
        slices = provider.non_terminated_nodes()
        assert len(slices) == 1
        assert len(provider.member_nodes(slices[0])) == 2
        anchored = [n for n in rt.state("nodes")
                    if "GPU-h100-16-head" in n["total"]]
        assert len(anchored) == 1
        assert all(n["total"].get("accelerator_type:H100") == 8.0
                   for n in rt.state("nodes") if n["total"].get("GPU"))

        deadline = time.time() + 90
        while time.time() < deadline:
            if any("scale-down" in e for e in scaler.events):
                break
            time.sleep(1.0)
        assert not provider.non_terminated_nodes(), scaler.events
    finally:
        scaler.stop()
        cluster.shutdown()


def test_gang_train_job_across_nodes(one_thread_daemons):
    """A two-worker gang spread over two nodes, joined into one gloo
    process group across them: each worker is local rank 0 of its node,
    and an all-reduce sums both ranks."""
    cluster = _fresh_cluster(head_resources={"CPU": 0.0})
    try:
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=2)
        cluster.connect()
        from ray_tpu_torch.train import (RunConfig, TorchBackendConfig,
                                         TorchTrainer)

        def train_fn(config):
            import os

            import torch
            import torch.distributed as dist

            from ray_tpu_torch import train as train_session
            from ray_tpu_torch.core.worker import CoreWorker

            x = torch.tensor([float(dist.get_rank() + 1)])
            dist.all_reduce(x)
            for step in range(3):
                train_session.report({
                    "step": step, "loss": 1.0 / (step + 1),
                    "sum": float(x), "node": CoreWorker.current().node_id,
                    "local_rank": int(os.environ["LOCAL_RANK"])})

        trainer = TorchTrainer(
            train_fn, torch_config=TorchBackendConfig(multi_controller=True),
            scaling_config=ScalingConfig(num_workers=2,
                                         resources_per_worker={"CPU": 1},
                                         placement_strategy="STRICT_SPREAD"),
            run_config=RunConfig(name="multinode-gang"))
        result = trainer.fit()
        assert result.error is None
        assert result.metrics["step"] == 2 and result.metrics["sum"] == 3.0
        assert result.metrics["local_rank"] == 0
    finally:
        cluster.shutdown()
