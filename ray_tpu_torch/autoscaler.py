"""Autoscaler: demand-driven node scale-up/down with pluggable providers.

The port's copy of ``ray_tpu/autoscaler.py``. The node half
(``NodeProvider``, ``LocalNodeProvider`` and the reconciling
``Autoscaler``): a node shape's ``GPU`` becomes the launched node's
``add_node(num_gpus=...)``, where the reference's ``TPU`` becomes
``num_tpus``. The slice half (``SliceBackend``, ``LocalSliceBackend``,
the GCE connectors and ``LocalGCEAPIServer``, ``GCESliceBackend``):
:class:`GPUSliceProvider` in the place of ``TPUSliceProvider`` launches a
whole GPU gang (``ScalingConfig(topology="h100-16")``'s hosts, the
``GPU-{gang}-head`` anchor on host 0) as one provider unit. The GCE
connectors speak the queued-resources REST shape; the only server they
reach in this repository is :class:`LocalGCEAPIServer` on loopback.

Capability parity with the reference's autoscaler v2 (reference:
``python/ray/autoscaler/v2/`` — an instance manager reconciling resource
demand from the GCS against a cloud NodeProvider; the v1 loop lives in
``autoscaler/_private/autoscaler.py:181``). Re-designed for this runtime:

- demand = the head's queued lease requests + unplaced PG bundles
  (``autoscaler_state`` RPC),
- an :class:`Autoscaler` loop launches nodes through a
  :class:`NodeProvider` when demand cannot fit in current capacity and
  retires nodes idle past ``idle_timeout_s``,
- :class:`LocalNodeProvider` spawns real node-daemon subprocesses (the
  test/laptop provider); cloud/k8s providers implement the same three
  methods against their APIs.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ._private.accelerators import normalize_pod_type


class NodeProvider:
    """Minimal provider surface (reference: ``node_provider.py``)."""

    def create_node(self, resources: Dict[str, float]) -> str:
        """Launch a node that will attach to the head; returns node id."""
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def member_nodes(self, provider_node_id: str) -> List[str]:
        """Cluster node ids behind one provider unit. A plain provider's
        unit IS one node; a slice provider's unit is a gang of hosts, and
        idleness/termination apply to the whole gang."""
        return [provider_node_id]


class LocalNodeProvider(NodeProvider):
    """Node daemons as local subprocesses (in-process cluster analogue)."""

    def __init__(self, cluster):
        self.cluster = cluster  # ray_tpu_torch.cluster_utils.Cluster
        self._nodes: Dict[str, Any] = {}

    def create_node(self, resources: Dict[str, float]) -> str:
        res = dict(resources)
        cpus = res.pop("CPU", 1)
        gpus = res.pop("GPU", 0)
        handle = self.cluster.add_node(num_cpus=cpus, num_gpus=gpus,
                                       resources=res or None)
        self._nodes[handle.node_id] = handle
        return handle.node_id

    def terminate_node(self, node_id: str) -> None:
        handle = self._nodes.pop(node_id, None)
        if handle is not None:
            self.cluster.remove_node(handle)

    def non_terminated_nodes(self) -> List[str]:
        # A daemon that died outside the provider (a crash, or
        # ``cluster.remove_node``) is terminated: it no longer counts
        # against ``max_nodes``, so a replacement can be launched, and
        # it is never waited on to go idle.
        for node_id, handle in list(self._nodes.items()):
            if handle.proc.poll() is not None:
                del self._nodes[node_id]
        return list(self._nodes)


#: Node labels of a launched gang host: its gang and its index in it.
SLICE_LABEL = "rt.io/gpu-slice"
WORKER_ID_LABEL = "rt.io/gpu-worker-id"


class SliceBackend:
    """Cloud-API surface behind :class:`GPUSliceProvider`: how one gang
    HOST is launched/terminated and how its cluster node id is read. A
    GCE/GKE deployment implements these against its API (queued
    resources / nodepools); the default backend materializes hosts as
    local node daemons."""

    def launch(self, slice_id: str, worker_id: int,
               resources: Dict[str, float], num_cpus: float,
               num_gpus: float) -> Any:
        """Start one host (non-blocking); returns an opaque handle."""
        raise NotImplementedError

    def finalize(self, slice_id: str, handles: List[Any]) -> None:
        """Barrier after every host of a slice launched (optional).
        Cloud backends usually no-op — their hosts register with the
        head asynchronously."""

    def terminate(self, handle: Any) -> None:
        raise NotImplementedError

    def node_id(self, handle: Any) -> str:
        """Cluster node id for a launched host ('' until registered)."""
        raise NotImplementedError


class LocalSliceBackend(SliceBackend):
    """Slice hosts as local node daemons (cluster_utils). Launch is
    non-blocking; ``finalize`` waits for the whole gang to register at
    once, so an N-host slice costs one registration wait, not N."""

    def __init__(self, cluster):
        self.cluster = cluster

    def launch(self, slice_id, worker_id, resources, num_cpus, num_gpus):
        return self.cluster.add_node(
            num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
            labels={SLICE_LABEL: slice_id,
                    WORKER_ID_LABEL: str(worker_id)},
            wait=False)

    def finalize(self, slice_id, handles):
        deadline = time.time() + 60
        waiting = {h.shm_domain: h for h in handles}
        while waiting:
            for n in self.cluster.list_nodes():
                h = waiting.pop(n["hostname"], None)
                if h is not None:
                    h.node_id = n["node_id"]
            if not waiting:
                return
            for h in waiting.values():
                if h.proc.poll() is not None:
                    raise RuntimeError(
                        f"slice {slice_id}: host daemon exited "
                        f"with {h.proc.returncode}")
            if time.time() > deadline:
                raise TimeoutError(
                    f"slice {slice_id}: {len(waiting)} host(s) never "
                    "registered")
            time.sleep(0.05)

    def terminate(self, handle):
        self.cluster.remove_node(handle)

    def node_id(self, handle):
        return handle.node_id


class GCEConnector:
    """Transport for the GCE queued-resources API (reference:
    ``python/ray/autoscaler/_private/gcp/node_provider.py`` — the
    provider speaks REST resource dicts; the transport is pluggable so
    a zero-egress deployment tests against :class:`FakeGCEConnector`
    while production swaps in an authenticated HTTP session)."""

    def create_queued_resource(self, parent: str, qr_id: str,
                               body: dict) -> dict:
        """POST {parent}/queuedResources?queued_resource_id={qr_id}."""
        raise NotImplementedError

    def get_queued_resource(self, name: str) -> dict:
        raise NotImplementedError

    def delete_queued_resource(self, name: str) -> dict:
        raise NotImplementedError


class FakeGCEConnector(GCEConnector):
    """In-memory GCE TPU API speaking the REAL queued-resource
    request/response shapes (``projects.locations.queuedResources`` —
    the create body's ``tpu.node_spec[].node`` carries
    ``accelerator_type``/``runtime_version``; reads report
    ``state.state`` transitions CREATING → WAITING_FOR_RESOURCES →
    PROVISIONING → ACTIVE). Strictly validates requests, so the
    conformance test proves :class:`GCESliceBackend` emits calls a real
    deployment would accept. ``fail_with`` simulates a stockout."""

    _STATES = ("CREATING", "WAITING_FOR_RESOURCES", "PROVISIONING",
               "ACTIVE")

    def __init__(self, polls_per_state: int = 1,
                 fail_with: Optional[str] = None):
        self.polls_per_state = polls_per_state
        self.fail_with = fail_with
        self.resources: Dict[str, dict] = {}  # name -> record
        self.requests: List[tuple] = []       # (verb, args) audit log

    def create_queued_resource(self, parent, qr_id, body):
        self.requests.append(("create", parent, qr_id, body))
        if not parent.startswith("projects/") or "/locations/" not in parent:
            raise ValueError(f"malformed parent {parent!r}")
        specs = body.get("tpu", {}).get("node_spec")
        if not specs:
            raise ValueError("body.tpu.node_spec is required")
        for spec in specs:
            node = spec.get("node") or {}
            if spec.get("parent") != parent:
                raise ValueError("node_spec.parent mismatch")
            if not spec.get("node_id"):
                raise ValueError("node_spec.node_id is required")
            if not node.get("accelerator_type"):
                raise ValueError("node.accelerator_type is required")
            if not node.get("runtime_version"):
                raise ValueError("node.runtime_version is required")
        name = f"{parent}/queuedResources/{qr_id}"
        if name in self.resources:
            # The real TPU API answers a duplicate queuedResourceId with
            # 409 Conflict / ALREADY_EXISTS (not 400); FileExistsError is
            # this codebase's spelling of that, and LocalGCEAPIServer
            # maps it to a genuine 409 envelope.
            raise FileExistsError(
                f"queued resource {qr_id!r} already exists")
        self.resources[name] = {"name": name, "body": body, "polls": 0}
        return {"name": f"{parent}/operations/op-{qr_id}", "done": False}

    def get_queued_resource(self, name):
        self.requests.append(("get", name))
        rec = self.resources.get(name)
        if rec is None:
            raise KeyError(f"404: {name} not found")
        if self.fail_with:
            return {"name": name,
                    "state": {"state": "FAILED",
                              "error": {"message": self.fail_with}}}
        idx = min(rec["polls"] // self.polls_per_state,
                  len(self._STATES) - 1)
        rec["polls"] += 1
        return {"name": name, "state": {"state": self._STATES[idx]},
                "tpu": rec["body"]["tpu"]}

    def delete_queued_resource(self, name):
        self.requests.append(("delete", name))
        if name not in self.resources:
            raise KeyError(f"404: {name} not found")
        del self.resources[name]
        return {"name": name + "/operations/delete", "done": True}


class HTTPGCEConnector(GCEConnector):
    """Queued-resources transport over real HTTP (reference:
    ``python/ray/autoscaler/_private/gcp/node_provider.py:1`` — there
    the googleapiclient discovery session; here stdlib ``http.client``
    against the TPU REST surface ``/v2/{parent}/queuedResources``).

    ``token_provider`` is a zero-arg callable returning a bearer token
    (production: the GCE metadata server or a service-account refresher;
    tests: a constant). Transient statuses (429/5xx) and connection
    drops retry with exponential backoff; 404 maps to ``KeyError`` and
    400 to ``ValueError`` so this class is a drop-in for
    :class:`FakeGCEConnector` under :class:`GCESliceBackend`.
    """

    RETRIABLE = (429, 500, 502, 503, 504)

    def __init__(self, endpoint: str = "https://tpu.googleapis.com", *,
                 token_provider=None, timeout_s: float = 30.0,
                 max_retries: int = 3, retry_base_s: float = 0.2):
        from urllib.parse import urlsplit

        parts = urlsplit(endpoint)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"unsupported endpoint {endpoint!r}")
        self._scheme = parts.scheme
        self._netloc = parts.netloc
        self._base_path = parts.path.rstrip("/")
        self.token_provider = token_provider
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.retry_base_s = retry_base_s

    def _request(self, method: str, path: str, body: Optional[dict] = None):
        import http.client
        import json as _json

        payload = _json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token_provider is not None:
            headers["Authorization"] = f"Bearer {self.token_provider()}"
        last_err: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                time.sleep(self.retry_base_s * (2 ** (attempt - 1)))
            conn_cls = (http.client.HTTPSConnection
                        if self._scheme == "https"
                        else http.client.HTTPConnection)
            conn = conn_cls(self._netloc, timeout=self.timeout_s)
            try:
                conn.request(method, self._base_path + path, payload,
                             headers)
                resp = conn.getresponse()
                raw = resp.read()
            except (OSError, http.client.HTTPException) as e:
                last_err = e
                continue
            finally:
                conn.close()
            if resp.status in self.RETRIABLE:
                last_err = RuntimeError(
                    f"{resp.status} {raw[:200].decode(errors='replace')}")
                continue
            try:
                doc = _json.loads(raw) if raw else {}
            except ValueError:
                doc = {"error": {"message": raw[:200].decode(
                    errors="replace")}}
            if resp.status == 404:
                raise KeyError(doc.get("error", {}).get(
                    "message", f"404: {path}"))
            if resp.status == 400:
                raise ValueError(doc.get("error", {}).get(
                    "message", f"400: {path}"))
            if resp.status == 409:
                # ALREADY_EXISTS / Conflict — the API's answer to a
                # duplicate queuedResourceId: a replayed create whose
                # first attempt committed must be adoptable, and the
                # production endpoint speaks 409, not 400.
                raise FileExistsError(doc.get("error", {}).get(
                    "message", f"409: {path}"))
            if resp.status in (401, 403):
                raise PermissionError(doc.get("error", {}).get(
                    "message", f"{resp.status}: {path}"))
            if resp.status >= 300:
                raise RuntimeError(
                    f"{resp.status}: {doc.get('error', doc)}")
            return doc
        raise ConnectionError(
            f"GCE API unreachable after {self.max_retries + 1} attempts: "
            f"{last_err}")

    def create_queued_resource(self, parent, qr_id, body):
        from urllib.parse import quote

        try:
            return self._request(
                "POST",
                f"/v2/{parent}/queuedResources"
                f"?queuedResourceId={quote(qr_id)}", body)
        except (FileExistsError, ValueError) as e:
            # The POST is retried on ambiguous connection failures, and
            # a lost RESPONSE means the first attempt may have committed
            # — the replay then answers 409 Conflict / ALREADY_EXISTS
            # (FileExistsError; legacy endpoints phrase it as a 400
            # "already exists"). Create is ensure-exists here: confirm
            # via GET and report success instead of failing a slice that
            # is provisioning. The message check applies to BOTH
            # exception types: 409 is Conflict, not only ALREADY_EXISTS
            # (e.g. "resource is being deleted" must still fail the
            # create so the caller retries later).
            msg = str(e).lower()
            if "already exists" not in msg and "already_exists" not in msg:
                raise
            name = f"{parent}/queuedResources/{qr_id}"
            try:
                self.get_queued_resource(name)
            except Exception:
                raise e from None
            return {"name": f"{parent}/operations/op-{qr_id}",
                    "done": False}

    def get_queued_resource(self, name):
        return self._request("GET", f"/v2/{name}")

    def delete_queued_resource(self, name):
        return self._request("DELETE", f"/v2/{name}")


class LocalGCEAPIServer:
    """Serves any :class:`GCEConnector` over the queued-resources REST
    routes on localhost — the zero-egress stand-in for the real
    ``tpu.googleapis.com`` front end, so :class:`HTTPGCEConnector` is
    exercised against the strict :class:`FakeGCEConnector` validations
    over an actual socket. Error mapping mirrors Google's JSON error
    envelope (``{"error": {"code", "message", "status"}}``)."""

    def __init__(self, connector: GCEConnector, *,
                 require_token: Optional[str] = None, port: int = 0):
        import http.server
        import json as _json
        import threading

        api = connector
        expected = require_token

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, doc: dict):
                raw = _json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _error(self, code: int, status: str, message: str):
                self._send(code, {"error": {"code": code,
                                            "message": message,
                                            "status": status}})

            def _authed(self) -> bool:
                if expected is None:
                    return True
                tok = self.headers.get("Authorization", "")
                if tok == f"Bearer {expected}":
                    return True
                self._error(401, "UNAUTHENTICATED",
                            "missing or invalid bearer token")
                return False

            def _dispatch(self, verb: str):
                if not self._authed():
                    return
                from urllib.parse import parse_qs, urlsplit

                parts = urlsplit(self.path)
                path = parts.path
                if not path.startswith("/v2/"):
                    return self._error(404, "NOT_FOUND", path)
                name = path[len("/v2/"):]
                try:
                    if verb == "POST":
                        if not name.endswith("/queuedResources"):
                            return self._error(404, "NOT_FOUND", path)
                        parent = name[:-len("/queuedResources")]
                        qs = parse_qs(parts.query)
                        qr_id = (qs.get("queuedResourceId")
                                 or qs.get("queued_resource_id")
                                 or [""])[0]
                        if not qr_id:
                            return self._error(
                                400, "INVALID_ARGUMENT",
                                "queuedResourceId is required")
                        n = int(self.headers.get("Content-Length") or 0)
                        body = _json.loads(self.rfile.read(n) or b"{}")
                        doc = api.create_queued_resource(parent, qr_id,
                                                         body)
                    elif verb == "GET":
                        doc = api.get_queued_resource(name)
                    else:
                        doc = api.delete_queued_resource(name)
                except KeyError as e:
                    return self._error(404, "NOT_FOUND", str(e.args[0]))
                except FileExistsError as e:
                    return self._error(409, "ALREADY_EXISTS", str(e))
                except ValueError as e:
                    return self._error(400, "INVALID_ARGUMENT", str(e))
                except Exception as e:  # connector bug -> 500
                    return self._error(500, "INTERNAL", repr(e))
                self._send(200, doc)

            def do_POST(self):
                self._dispatch("POST")

            def do_GET(self):
                self._dispatch("GET")

            def do_DELETE(self):
                self._dispatch("DELETE")

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler)
        self.endpoint = (f"http://127.0.0.1:"
                         f"{self._httpd.server_address[1]}")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="gce-api-server")
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class _GCESliceHandle:
    __slots__ = ("qr_name", "worker_id", "node_id")

    def __init__(self, qr_name: str, worker_id: int):
        self.qr_name = qr_name
        self.worker_id = worker_id
        self.node_id = ""


class GCESliceBackend(SliceBackend):
    """SliceBackend provisioning through GCE queued resources: one
    gang = ONE queued resource (a multi-host node), whose node spec
    names the gang's accelerator type (its normalised topology,
    ``h100-16``). host 0's
    launch creates it, other hosts attach to the same handle, and
    ``finalize`` polls until ACTIVE. Cluster node ids arrive when the
    hosts' daemons register with the head (as on real TPU VMs, where a
    startup script joins the cluster)."""

    def __init__(self, connector: GCEConnector, pod_type: str, *,
                 project: str = "default-project",
                 zone: str = "us-central2-b",
                 runtime_version: str = "ubuntu2204-cuda",
                 poll_interval_s: float = 0.05,
                 provision_timeout_s: float = 600.0,
                 list_nodes=None):
        self.connector = connector
        self.pod_type = pod_type
        self.parent = f"projects/{project}/locations/{zone}"
        self.runtime_version = runtime_version
        self.poll_interval_s = poll_interval_s
        self.provision_timeout_s = provision_timeout_s
        # () -> cluster node dicts (the head's list_nodes). GCE hosts
        # join the cluster via their startup script carrying the slice
        # labels; this resolves handles to node ids so
        # the autoscaler's idle accounting (and scale-DOWN) works.
        # Without it node ids stay "", which reads as fully-busy —
        # conservative: never terminates a slice it can't account.
        self.list_nodes = list_nodes

    def launch(self, slice_id, worker_id, resources, num_cpus, num_gpus):
        name = f"{self.parent}/queuedResources/{slice_id}"
        if worker_id == 0:
            self.connector.create_queued_resource(
                self.parent, slice_id, {
                    "tpu": {"node_spec": [{
                        "parent": self.parent,
                        "node_id": slice_id,
                        "node": {
                            "accelerator_type": normalize_pod_type(
                                self.pod_type),
                            "runtime_version": self.runtime_version,
                        },
                    }]},
                })
        return _GCESliceHandle(name, worker_id)

    def finalize(self, slice_id, handles):
        name = handles[0].qr_name
        deadline = time.time() + self.provision_timeout_s
        while True:
            rec = self.connector.get_queued_resource(name)
            state = rec.get("state", {}).get("state")
            if state == "ACTIVE":
                return
            if state in ("FAILED", "SUSPENDED"):
                msg = rec.get("state", {}).get("error", {}).get(
                    "message", state)
                raise RuntimeError(
                    f"queued resource {slice_id}: {msg}")
            if time.time() > deadline:
                raise TimeoutError(
                    f"queued resource {slice_id} stuck in {state}")
            time.sleep(self.poll_interval_s)

    def terminate(self, handle):
        if handle.worker_id != 0:
            return  # the slice's single queued resource is deleted once
        try:
            self.connector.delete_queued_resource(handle.qr_name)
        except KeyError:
            pass  # already gone (failed create teardown)

    def node_id(self, handle):
        if not handle.node_id and self.list_nodes is not None:
            slice_id = handle.qr_name.rsplit("/", 1)[1]
            try:
                for n in self.list_nodes():
                    labels = n.get("labels") or {}
                    if labels.get(SLICE_LABEL) == slice_id and \
                            labels.get(WORKER_ID_LABEL) == \
                            str(handle.worker_id):
                        handle.node_id = n["node_id"]
                        break
            except Exception:  # noqa: BLE001 - stay conservative
                pass
        return handle.node_id


class GPUSliceProvider(NodeProvider):
    """GPU gang provider: one ``create_node`` call = one whole gang of
    hosts, never a partial one (the reference's ``TPUSliceProvider``,
    ``autoscaler.py:578``): a gang trains as one job, and a lost host
    breaks it.

    ``pod_type`` (e.g. ``"h100-16"``) fixes the gang's shape:
    ``num_hosts(pod_type)`` hosts x ``cards_per_host`` cards. Hosts carry
    the resource shape a detected gang host advertises (``GPU: n`` per
    host, the ``accelerator_type:{MODEL}`` label, the
    ``GPU-{gang}-head`` anchor on host 0), so gang scheduling behaves as
    on a detected gang. The provisioning calls live in a pluggable
    :class:`SliceBackend`.
    """

    def __init__(self, cluster, pod_type: str = "h100-16", *,
                 cpus_per_host: float = 4.0,
                 backend: Optional[SliceBackend] = None):
        from ._private import accelerators as acc

        self.pod_type = acc.normalize_pod_type(pod_type)
        model, cards = acc.parse_topology(self.pod_type)
        self.hosts_per_slice = acc.num_hosts(self.pod_type)
        self.cards_per_host = cards // self.hosts_per_slice
        self.cpus_per_host = cpus_per_host
        self.model = model
        self.backend = backend or LocalSliceBackend(cluster)
        self._slices: Dict[str, List[Any]] = {}  # slice_id -> host handles
        self._seq = 0

    def _host_resources(self, worker_id: int) -> Dict[str, float]:
        from ._private import accelerators as acc

        # the shape a detected gang host advertises: one rule, in the
        # accelerator layer
        return acc.gang_resources(self.cards_per_host,
                                  pod_type=self.pod_type,
                                  worker_id=worker_id)

    def create_node(self, resources: Dict[str, float]) -> str:
        """Launch one full gang; ``resources`` (the generic per-node
        ask) is subsumed by the gang's shape. A launch failure tears the
        partial gang down: half a gang can never gang-schedule and would
        leak hosts."""
        self._seq += 1
        slice_id = f"{self.pod_type}-slice-{self._seq}"
        hosts: List[Any] = []
        try:
            for wid in range(self.hosts_per_slice):
                hosts.append(self.backend.launch(
                    slice_id, wid, self._host_resources(wid),
                    self.cpus_per_host, self.cards_per_host))
            self.backend.finalize(slice_id, hosts)
        except Exception:
            for h in hosts:
                try:
                    self.backend.terminate(h)
                except Exception:  # noqa: BLE001 - best-effort teardown
                    pass
            raise
        self._slices[slice_id] = hosts
        return slice_id

    def terminate_node(self, node_id: str) -> None:
        remaining = []
        for handle in self._slices.pop(node_id, []):
            try:
                self.backend.terminate(handle)
            except Exception:  # noqa: BLE001 - keep for a retry pass
                remaining.append(handle)
        if remaining:
            # partial teardown: keep the leftovers visible so the next
            # idle pass retries them instead of orphaning live hosts
            self._slices[node_id] = remaining

    def non_terminated_nodes(self) -> List[str]:
        return list(self._slices)

    def member_nodes(self, provider_node_id: str) -> List[str]:
        return [self.backend.node_id(h)
                for h in self._slices.get(provider_node_id, [])]

    def slices_needed(self, state: dict) -> int:
        """Demand in gangs: pending ``GPU`` asks divided by a gang's
        cards, plus one gang per anchor/label-only ask. Generic CPU
        demand never launches a gang; pass this as the autoscaler's
        ``demand_fn``."""
        cards = 0.0
        anchors = 0
        for shape in state.get("pending_resource_shapes", ()):
            gpu_keys = [k for k in shape
                        if k == "GPU" or k.startswith("GPU-")
                        or k == f"accelerator_type:{self.model.upper()}"]
            if not gpu_keys:
                continue
            c = shape.get("GPU", 0.0)
            if c > 0:
                cards += c
            else:
                anchors += 1
        per_slice = self.cards_per_host * self.hosts_per_slice
        return math.ceil(cards / per_slice) + anchors


class Autoscaler:
    """Reconciling loop: head demand → provider node count."""

    def __init__(self, provider: NodeProvider, *,
                 node_resources: Optional[Dict[str, float]] = None,
                 min_nodes: int = 0, max_nodes: int = 4,
                 idle_timeout_s: float = 30.0,
                 poll_period_s: float = 1.0,
                 demand_fn=None):
        self.provider = provider
        self.node_resources = node_resources or {"CPU": 2.0}
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.idle_timeout_s = idle_timeout_s
        self.poll_period_s = poll_period_s
        # state dict -> provider UNITS needed (nodes for a plain
        # provider). Default: ~2 queued demand items per new node.
        self.demand_fn = demand_fn or (
            lambda s: (s["pending_lease_requests"]
                       + s["unplaced_pg_bundles"] + 1) // 2)
        self._idle_since: Dict[str, float] = {}
        # (launch time, units) — just-launched capacity the demand
        # signal can't see yet (hosts still registering); counted
        # against demand for launch_grace_s to prevent double-launch.
        self.launch_grace_s = 30.0
        self._recent_launches: List[tuple] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # human-readable scaling decisions; bounded so a prolonged head
        # outage (one reconcile error per poll) can't grow memory forever
        self.events: Any = deque(maxlen=1000)

    # ------------------------------------------------------------- state
    def _demand(self) -> dict:
        from ray_tpu_torch.core.worker import CoreWorker

        return CoreWorker.current().head_call("autoscaler_state")

    def reconcile_once(self) -> None:
        state = self._demand()
        nodes = self.provider.non_terminated_nodes()
        now = time.time()
        self._recent_launches = [
            (t, c) for t, c in self._recent_launches
            if now - t < self.launch_grace_s]
        pending = self.demand_fn(state) \
            - sum(c for _, c in self._recent_launches)
        if pending > 0 and len(nodes) < self.max_nodes:
            n_new = min(self.max_nodes - len(nodes), pending)
            for _ in range(n_new):
                node_id = self.provider.create_node(self.node_resources)
                self.events.append(
                    f"scale-up {node_id[:12]} (pending={pending})")
            self._recent_launches.append((time.time(), n_new))
            return
        # Scale down: retire provider units idle past the timeout. A
        # unit spanning several cluster nodes (a TPU slice) is idle only
        # when EVERY member host is.
        util = state["node_utilization"]  # node_id -> busy fraction
        now = time.time()
        for node_id in nodes:
            members = self.provider.member_nodes(node_id)
            busy = max((util.get(m, 1.0) for m in members), default=1.0)
            if busy > 0:
                self._idle_since.pop(node_id, None)
                continue
            first_idle = self._idle_since.setdefault(node_id, now)
            if (now - first_idle > self.idle_timeout_s
                    and len(self.provider.non_terminated_nodes())
                    > self.min_nodes):
                self.provider.terminate_node(node_id)
                self._idle_since.pop(node_id, None)
                self.events.append(f"scale-down {node_id[:12]} (idle)")

    # -------------------------------------------------------------- loop
    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rt-autoscaler")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.poll_period_s):
            try:
                self.reconcile_once()
            except Exception as e:  # noqa: BLE001 - transient head hiccups
                self.events.append(
                    f"reconcile error: {type(e).__name__}: {e}")

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
