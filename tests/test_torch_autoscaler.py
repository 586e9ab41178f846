"""The port's autoscaler (the node half of ``autoscaler.py``), head
persistence and usage stats, and one multi-node operations scenario run
through both packages.

The reference's cases of ``test_ha_autoscaler.py`` but the TPU slice
provider's (whose GPU counterpart is
``test_torch_gang.py::test_gpu_slice_provider_gang_scale``), on the
port. Port-only: a ``GPU`` node shape launched
for a ``num_gpus=1`` actor, which restarts on a replacement node after
its node is killed, then scales down once idle; and a scenario (a
two-node cluster, the CLI's ``status``/``list nodes`` keys, job
statuses and the autoscaler's event kinds) that must give equal results
over ``ray_tpu`` and ``ray_tpu_torch``, each in a subprocess.
"""
import json
import os
import subprocess
import sys
import time

import pytest

from torch_runtime import case_time_limit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CASE_LIMIT_S = 180.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No runtime before or after a case; one-thread daemons."""
    import ray_tpu_torch as rt

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if rt.is_initialized():
        rt.shutdown()
    yield
    if rt.is_initialized():
        rt.shutdown()


def _wait_event(scaler, kind, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if any(e.startswith(kind) for e in scaler.events):
            return True
        time.sleep(0.2)
    return False


def test_head_state_snapshot_restore():
    """KV, named-actor records and jobs survive a head restart on the
    same session directory."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch.api import _HeadThread
    from ray_tpu_torch.core.worker import CoreWorker

    # A short directory: under pytest-xdist, ``tmp_path`` + the driver's
    # ``workers/<id>.sock`` passes sockaddr_un's 108 bytes.
    session = os.path.join(tempfile.mkdtemp(prefix="rtt_snap_"), "session")
    os.makedirs(session)
    ht = _HeadThread(session, Config({}), {"CPU": 4.0}).start()
    rt.init(address=ht.head.sock_path)

    @rt.remote
    class Named:
        def ping(self):
            return 1

    Named.options(name="survivor").remote()
    CoreWorker.current().kv_put("durable_key", b"durable_value", ns="app")
    time.sleep(0.5)
    rt.shutdown()
    ht.stop()  # the head persists its state on stop
    assert os.path.exists(os.path.join(session, "head_state.pkl"))
    ht2 = _HeadThread(session, Config({}), {"CPU": 4.0}).start()
    rt.init(address=ht2.head.sock_path)
    try:
        core2 = CoreWorker.current()
        assert core2.kv_get("durable_key", ns="app") == b"durable_value"
        survivor = [a for a in rt.state("actors") if a["name"] == "survivor"]
        # Live at the snapshot: restored RESTARTING (the reconnect grace
        # window); with its process gone, DEAD once the grace expires.
        assert survivor and survivor[0]["state"] in ("RESTARTING", "DEAD")
        if survivor[0]["state"] == "DEAD":
            assert "reconnect" in survivor[0]["death_cause"] or \
                "head restart" in survivor[0]["death_cause"]
    finally:
        rt.shutdown()
        ht2.stop()


def test_autoscaler_scales_up_and_down():
    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_resources={"CPU": 0.0},
                      system_config={"worker_lease_timeout_s": 60.0})
    rt = cluster.connect()
    provider = LocalNodeProvider(cluster)
    scaler = Autoscaler(provider, node_resources={"CPU": 2.0},
                        min_nodes=0, max_nodes=2, idle_timeout_s=4.0,
                        poll_period_s=0.5).start()
    try:
        @rt.remote
        def work(x):
            time.sleep(0.3)
            return x

        # No CPU in the cluster: demand queues, the scaler adds nodes.
        refs = [work.remote(i) for i in range(6)]
        assert rt.get(refs, timeout=90) == list(range(6))
        assert len(provider.non_terminated_nodes()) >= 1
        assert any("scale-up" in e for e in scaler.events)
        # Idle past the timeout: back to min_nodes. Wait on the event:
        # terminate pops the provider's list before the node's removal
        # returns.
        assert _wait_event(scaler, "scale-down", 90), scaler.events
        assert not provider.non_terminated_nodes(), scaler.events
    finally:
        scaler.stop()
        cluster.shutdown()


def test_gpu_node_scale_up_replacement_and_down():
    """Port-only, the CPU rehearsal of ``chip_smoke.cluster_phase`` (e):
    a ``num_gpus=1, max_restarts=1`` actor asked for while no node has
    ``GPU`` makes the autoscaler launch a ``{"CPU": 1, "GPU": 1}`` node;
    the driver's put reaches the actor over TCP; killing the node makes
    it launch a replacement where the actor restarts; after the actor
    is killed and the idle timeout passes, a scale-down leaves no
    provider node and no ``GPU``."""
    import numpy as np

    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_resources={"CPU": 2.0},
                      system_config={"worker_lease_timeout_s": 120.0})
    rt = cluster.connect()
    provider = LocalNodeProvider(cluster)
    scaler = Autoscaler(provider, node_resources={"CPU": 1.0, "GPU": 1.0},
                        min_nodes=0, max_nodes=1, idle_timeout_s=2.0,
                        poll_period_s=0.3)
    # Relaunch as soon as demand shows (the default grace is 30 s).
    scaler.launch_grace_s = 1.0
    scaler.start()
    try:
        assert "GPU" not in rt.cluster_resources()
        weights = rt.put(np.arange(1 << 20, dtype=np.float32))

        @rt.remote(num_gpus=1, max_restarts=1)
        class Host:
            def __init__(self, w):
                import ray_tpu_torch as rt

                self.total = float(rt.get(w).sum()) if isinstance(
                    w, rt.ObjectRef) else float(w.sum())

            def where(self):
                from ray_tpu_torch.core.worker import CoreWorker

                return CoreWorker.current().node_id, self.total

        actor = Host.remote(weights)
        node1, total = rt.get(actor.where.remote(), timeout=120)
        assert total == float(np.arange(1 << 20, dtype=np.float32).sum())
        assert provider.non_terminated_nodes() == [node1]
        assert rt.cluster_resources()["GPU"] == 1.0
        cluster.remove_node(cluster._nodes[0], graceful=False)
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                node2, total2 = rt.get(actor.where.remote(), timeout=10)
                if node2 != node1:
                    break
            except Exception:  # noqa: BLE001 - restarting
                time.sleep(0.3)
        else:
            pytest.fail(f"actor never restarted: {list(scaler.events)}")
        assert total2 == total
        assert provider.non_terminated_nodes() == [node2]
        ups = [e for e in scaler.events if e.startswith("scale-up")]
        assert len(ups) == 2, scaler.events
        rt.kill(actor)
        assert _wait_event(scaler, "scale-down", 60), scaler.events
        assert not provider.non_terminated_nodes()
        deadline = time.time() + 30
        while rt.cluster_resources().get("GPU") and time.time() < deadline:
            time.sleep(0.2)
        assert not rt.cluster_resources().get("GPU")
    finally:
        scaler.stop()
        cluster.shutdown()


def test_usage_stats_local_only(tmp_path, monkeypatch):
    from ray_tpu_torch._private import usage_stats

    usage_stats.record_feature("unit_test_feature")
    rep = usage_stats.report()
    assert rep["features"]["unit_test_feature"] >= 1
    path = usage_stats.write_report(str(tmp_path))
    with open(path) as f:
        assert json.load(f)["schema_version"] == 1
    monkeypatch.setenv("RT_USAGE_STATS_DISABLED", "1")
    assert usage_stats.write_report(str(tmp_path / "nope")) == ""


SCENARIO = r'''
import importlib
import json
import subprocess
import sys
import time

PKG = sys.argv[1]
rt = importlib.import_module(PKG)
cu = importlib.import_module(PKG + ".cluster_utils")
asc = importlib.import_module(PKG + ".autoscaler")
js = importlib.import_module(PKG + ".job_submission")
ACCEL = "GPU" if PKG == "ray_tpu_torch" else "TPU"
out = {}


def accel(res):
    res = {k: v for k, v in res.items() if k != "memory"}
    if ACCEL in res:
        res["ACCEL"] = res.pop(ACCEL)
    return {k: res[k] for k in sorted(res)}


c = cu.Cluster(head_resources={"CPU": 0.0},
               system_config={"worker_lease_timeout_s": 60.0})
try:
    c.add_node(num_cpus=1)
    c.add_node(num_cpus=1, **{f"num_{ACCEL.lower()}s": 1})
    rt = c.connect()
    out["cluster"] = accel(rt.cluster_resources())
    nodes = c.list_nodes()
    out["node_keys"] = sorted(set().union(*(n.keys() for n in nodes)))
    out["nodes"] = sorted(json.dumps([n["is_head"], n["state"],
                                      accel(n["total"])]) for n in nodes)

    def cli(*argv):
        r = subprocess.run([sys.executable, "-m", PKG, "--session-dir",
                            c.session_dir, *argv], capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        return r.stdout

    out["status_keys"] = [ln.split(":")[0].strip()
                          for ln in cli("status").splitlines()
                          if ln.startswith("  ")]
    listed = json.loads(cli("list", "nodes"))
    out["list_node_keys"] = sorted(set().union(*(n.keys() for n in listed)))

    client = js.JobSubmissionClient(c.address)
    ok = client.submit_job(entrypoint=f"{sys.executable} -c 'print(7 * 6)'")
    bad = client.submit_job(entrypoint=f"{sys.executable} -c "
                                       "'raise SystemExit(3)'")
    slow = client.submit_job(entrypoint="sleep 30")
    out["jobs"] = [client.wait_until_finished(ok, 60),
                   client.wait_until_finished(bad, 60)]
    out["stopped"] = client.stop_job(slow)["status"]
    out["stopped_final"] = client.wait_until_finished(slow, 60)
    out["job_logs"] = client.get_job_logs(ok).strip()
    out["job_info_keys"] = sorted(client.get_job_info(bad))
    out["returncode"] = client.get_job_info(bad)["returncode"]
    out["listed_jobs"] = len(client.list_jobs())

    provider = asc.LocalNodeProvider(c)
    scaler = asc.Autoscaler(provider,
                            node_resources={"CPU": 1.0, "special": 1.0},
                            min_nodes=0, max_nodes=1, idle_timeout_s=1.0,
                            poll_period_s=0.2).start()

    @rt.remote(resources={"special": 1.0})
    def special(x):
        return x + 1

    out["special"] = rt.get([special.remote(i) for i in range(3)],
                            timeout=120)
    deadline = time.time() + 60
    while time.time() < deadline and not any(
            e.startswith("scale-down") for e in scaler.events):
        time.sleep(0.2)
    scaler.stop()
    kinds = []
    for e in scaler.events:
        if e.split()[0] not in kinds:
            kinds.append(e.split()[0])
    out["event_kinds"] = kinds
    out["provider_nodes_after"] = len(provider.non_terminated_nodes())
finally:
    c.shutdown()
print("SCENARIO " + json.dumps(out, sort_keys=True))
'''


def test_operations_scenario_equal_to_reference(tmp_path):
    path = tmp_path / "ops_scenario.py"
    path.write_text(SCENARIO)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = {pkg: subprocess.Popen(
        [sys.executable, str(path), pkg], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    got = {}
    for pkg, p in procs.items():
        stdout, stderr = p.communicate(timeout=170)
        lines = [ln for ln in stdout.splitlines()
                 if ln.startswith("SCENARIO ")]
        assert p.returncode == 0 and lines, (pkg, p.returncode,
                                             stderr[-3000:])
        got[pkg] = json.loads(lines[-1][len("SCENARIO "):])
    ref, port = got["ray_tpu"], got["ray_tpu_torch"]
    assert ref.keys() == port.keys()
    for key in ref:
        assert port[key] == ref[key], key
    # the scenario saw what it was written to see
    assert port["cluster"] == {"ACCEL": 1.0, "CPU": 2.0}
    assert port["jobs"] == ["SUCCEEDED", "FAILED"]
    assert port["stopped_final"] == "STOPPED" and port["returncode"] == 3
    assert port["job_logs"] == "42"
    assert port["special"] == [1, 2, 3]
    assert port["event_kinds"] == ["scale-up", "scale-down"]
    assert port["provider_nodes_after"] == 0
    assert "nodes" in port["status_keys"]
