"""The port's engine records what the reference's engine records: the same
flight-recorder events and the same serve-metric deltas, for the same
requests on the same weights (CPU, nano f32).

Each scenario runs once through the reference's ``DecodeEngine`` and once
through the port's, every request submitted before ``start()`` so both
take the same dispatches:

- ``greedy``: paged, the decode kernel path (the reference's
  ``attn_kernel="pallas"``, the port's ``"cuda"``), a request whose
  deadline has passed;
- ``sampled``: seeded T=0.8 over a tight pool with the prefix cache on:
  a repeated prompt forks a page copy-on-write, later admissions evict
  cached prefixes;
- ``preempt``: a pool too small for two lanes, so the youngest is
  preempted by recompute;
- ``spec``: n-gram speculative decoding;
- ``handoff``: a prefill engine exports two requests (one lease expires
  and is swept), a decode engine imports one and falls back to a local
  prefill for a payload whose digest does not match, then the lease is
  claimed;
- ``resume``: a ``resume_from`` resubmission;
- ``driver_die``: an injected driver death, the supervisor's restart and
  the resumed stream.

Events are captured by replacing ``_driver_emit`` and ``events.emit`` in
both packages' engine and ``data.llm`` modules (restored afterwards), so
the rate caps play no part: kinds, order and every attribute but the
``dispatch_s`` timing must be equal, request ids included (both engines
mint ``eng-<pid hex>-<n>`` in this process). Metrics are compared as
deltas of every instrument labelled with the scenario's deployment:
counters by value, gauges by final value, histograms by bucket counts
(by count alone for the timing histograms). The reference's recorder is
never enabled and the environment is not touched; the port's real ring
is checked on a ``tmp_path``.
"""
import dataclasses
import threading
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.data.llm as jllm
import ray_tpu.serve.engine as jengine
from ray_tpu._private import events as jev
from ray_tpu._private.metrics import serve_metrics as jserve_metrics
from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.batching import _EngineStream as JaxStream
import ray_tpu_torch.data.llm as tllm
import ray_tpu_torch.serve.engine as tengine
from ray_tpu_torch._private import events as tev
from ray_tpu_torch._private.metrics import serve_metrics as tserve_metrics
from ray_tpu_torch.data import block as TB
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve._stream import _EngineStream

J32 = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
T32 = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
KW = dict(slots=2, chunk=4, max_len=64, prompt_buckets=(16,),
          paged=True, page_size=8, attn_kernel="pallas")
#: Histograms of durations: compared by count only.
TIMING = ("engine_admission_wait", "kv_handoff")
# An injected driver death re-raises in the driver thread, as the
# reference's does: the thread's exception is the fault, not a failure.
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")


@pytest.fixture(scope="module")
def params():
    # The port draws the reference's weights for seed 0 bit for bit
    # (tests/test_torch_init_params.py); the reference gets the same
    # leaves in its own layout.
    port = tgpt.init_params(T32, 0, device="cpu")
    ref = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                 tgpt.params_tree(port))
    return {"ref": ref, "port": port}


def _prompt(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(3100 + seed).integers(
        0, J32.vocab_size, (n,)).astype(np.int32)


class Pkg:
    """One package's engine factory and stream reader; keywords use the
    reference's vocabulary (``attn_kernel="pallas"`` is the port's
    ``"cuda"``)."""

    def __init__(self, name: str, params):
        self.name, self.params = name, params
        self.port = name == "port"
        self.restart_error = (tengine if self.port else jengine
                              ).EngineRestartError

    def engine(self, deployment: str, auto_start: bool = False, **kw):
        kw = {**KW, **kw}
        if not kw["paged"]:
            kw.pop("attn_kernel")
            kw.pop("page_size")
        if self.port:
            if kw.get("attn_kernel") == "pallas":
                kw["attn_kernel"] = "cuda"
            return tengine.DecodeEngine(
                self.params, T32, device="cpu", deployment=deployment,
                auto_start=auto_start, **kw)
        return jengine.DecodeEngine(self.params, J32, deployment=deployment,
                                    auto_start=auto_start, **kw)

    def drain(self, lane) -> np.ndarray:
        pieces = list((_EngineStream if self.port else JaxStream)(lane))
        return np.concatenate(pieces) if pieces else np.zeros(0, np.int32)


# ------------------------------------------------------------ scenarios
def _serve(pkg, eng, reqs):
    """Submit every (prompt, max_new, kw) before start, then drain."""
    try:
        lanes = [eng.submit(p, m, **kw) for p, m, kw in reqs]
        eng.start()
        outs = []
        for lane in lanes:
            try:
                outs.append(pkg.drain(lane))
            except Exception as e:  # noqa: BLE001 - an expired request
                outs.append(type(e).__name__)
        return outs, eng.stats()
    finally:
        eng.shutdown()


def sc_greedy(pkg, dep):
    reqs = [(_prompt(0, 5), 6, {}), (_prompt(1, 12), 9, {}),
            (_prompt(2, 7), 4, {"deadline_s": time.time() - 1.0}),
            (_prompt(3, 16), 5, {})]
    return _serve(pkg, pkg.engine(dep), reqs)


def sc_sampled(pkg, dep):
    a = _prompt(4, 12)
    reqs = [(a, 8, {"seed": 1}), (a, 8, {"seed": 2})]
    reqs += [(_prompt(5 + i, n), 8, {"seed": 3 + i})
             for i, n in enumerate((16, 15, 13, 14, 11))]
    return _serve(pkg, pkg.engine(dep, temperature=0.8, n_pages=8), reqs)


def sc_preempt(pkg, dep):
    reqs = [(_prompt(10 + i, 16), 24, {"seed": 7 + i}) for i in range(2)]
    return _serve(pkg, pkg.engine(dep, temperature=0.8, n_pages=8,
                                  prefix_cache=False), reqs)


def sc_spec(pkg, dep):
    loop = np.tile(_prompt(12, 4), 4)
    reqs = [(loop, 16, {}), (_prompt(13, 9), 12, {})]
    return _serve(pkg, pkg.engine(dep, spec_decode="ngram"), reqs)


def sc_resume(pkg, dep):
    reqs = [(_prompt(14, 10), 10, {"resume_from": 4}),
            (_prompt(15, 6), 5, {})]
    return _serve(pkg, pkg.engine(dep), reqs)


def sc_handoff(pkg, dep):
    pre = pkg.engine(dep + "-pre", role="prefill")
    dec = pkg.engine(dep + "-dec", role="decode")
    try:
        pre.start()
        desc = pre.handoff(_prompt(16, 11), 9, seed=3)
        lost = pre.handoff(_prompt(17, 6), 7, seed=4, ttl_s=0.05)
        deadline = time.time() + 10
        while pre.stats()["handoff"]["leases_reclaimed"] < 1:
            assert time.time() < deadline, "the lease was never swept"
            time.sleep(0.01)
        # The second payload's digest does not match the descriptor's:
        # a counted fallback to a local prefill.
        outs, stats = _serve_prefilled(
            pkg, dec, [desc, dict(lost, digest="0" * 64)])
        assert pre.claim_handoff(desc["lease_id"], desc["epoch"])
        assert stats["handoff"] == {
            "exported": 0, "imported": 1, "import_fallbacks": 1,
            "ship_bytes": 0, "leases_outstanding": 0, "leases_claimed": 0,
            "leases_reclaimed": 0}
        return outs, stats
    finally:
        pre.shutdown()
        dec.shutdown()


def _serve_prefilled(pkg, eng, descs):
    """Admit every handoff descriptor before start, then drain."""
    try:
        lanes = [eng.admit_prefilled(d) for d in descs]
        eng.start()
        return [pkg.drain(lane) for lane in lanes], eng.stats()
    finally:
        eng.shutdown()


def sc_driver_die(pkg, dep):
    eng = pkg.engine(dep)
    try:
        prompt = _prompt(18, 9)
        eng.inject_fault("driver_die", at_tokens=5)
        lane = eng.submit(prompt, 16, seed=0)
        eng.start()
        got = []
        with pytest.raises(pkg.restart_error):
            for piece in (_EngineStream if pkg.port else JaxStream)(lane):
                got.extend(int(t) for t in np.asarray(piece).ravel())
        eng._thread.join(timeout=10)
        assert eng.supervise() is True
        tail = pkg.drain(eng.submit(prompt, 16, seed=0,
                                    resume_from=len(got)))
        return [np.concatenate([np.asarray(got, np.int32), tail])], \
            eng.stats()
    finally:
        eng.shutdown()


SCENARIOS = {"greedy": sc_greedy, "sampled": sc_sampled,
             "preempt": sc_preempt, "spec": sc_spec,
             "handoff": sc_handoff, "resume": sc_resume,
             "driver_die": sc_driver_die}


# ------------------------------------------------------------ the runner
class Capture:
    """Stands in for ``_driver_emit`` and ``events.emit``: records
    ``(kind, attrs)`` in call order."""

    def __init__(self):
        self.events = []
        self._lock = threading.Lock()

    def __call__(self, kind, **attrs):
        with self._lock:
            self.events.append((kind, attrs))
        return True


def _capture(mp, engine_mod, llm_mod, events_mod) -> Capture:
    cap = Capture()
    mp.setattr(engine_mod, "_driver_emit", cap)
    mp.setattr(llm_mod, "_driver_emit", cap)
    mp.setattr(events_mod, "emit", cap)
    return cap


def _metric_values(sm, dep):
    """{(instrument key, labels): value} for every series whose
    deployment label starts with ``dep``."""
    out = {}
    for key, inst in sm.items():
        for labels, v in inst.collect():
            if any(k == "deployment" and str(val).startswith(dep)
                   for k, val in labels):
                out[key, labels] = v
    return out


def _deltas(sm, dep, before, after):
    """Deltas keyed by labels with ``dep`` written as ``D``."""
    out = {}
    for (key, labels), v in after.items():
        kind, old = sm[key].kind, before.get((key, labels))
        labels = tuple((k, x.replace(dep, "D", 1) if k == "deployment"
                        else x) for k, x in labels)
        if kind == "gauge":
            out[key, labels] = v
        elif kind == "counter":
            d = v - (old or 0.0)
            if d:
                out[key, labels] = d
        else:
            d = [a - b for a, b in zip(v, old or [0] * len(v))]
            if d[-1]:
                out[key, labels] = d[-1] if key in TIMING else \
                    d[:-2] + [d[-1]]
    return out


_RUNS = {}


def _run(name, params):
    """Run scenario ``name`` through both packages once per module:
    {"ref"/"port": (events, metric deltas, outputs, stats)}."""
    if name in _RUNS:
        return _RUNS[name]
    res = {}
    # One deployment for both: the two registries are separate, and
    # ``engine.driver_restart`` carries it.
    dep = f"evp-{name}-{uuid.uuid4().hex[:8]}"
    for pkg_name, sm, mods in (
            ("ref", jserve_metrics(), (jengine, jllm, jev)),
            ("port", tserve_metrics(), (tengine, tllm, tev))):
        pkg = Pkg(pkg_name, params[pkg_name])
        before = _metric_values(sm, dep)
        with pytest.MonkeyPatch.context() as mp:
            cap = _capture(mp, *mods)
            outs, stats = SCENARIOS[name](pkg, dep)
        res[pkg_name] = (cap.events,
                         _deltas(sm, dep, before, _metric_values(sm, dep)),
                         outs, stats)
    _RUNS[name] = res
    return res


def _norm(events):
    """Events without their timing attribute, which must be a
    non-negative float where present."""
    out = []
    for kind, attrs in events:
        a = dict(attrs)
        if kind == "engine.dispatch" and not a.get("spec"):
            t = a.pop("dispatch_s")
            assert isinstance(t, float) and t >= 0.0, (kind, t)
        out.append((kind, a))
    return out


def _same_outputs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, str) or isinstance(y, str):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)


# What each scenario must show, beyond equality.
MUST = {"greedy": {"engine.admit", "engine.page_alloc", "engine.dispatch"},
        "sampled": {"engine.page_evict"},
        "preempt": {"engine.preempt"},
        "spec": {"engine.dispatch"},
        "handoff": {"handoff.grant", "engine.export", "handoff.reclaim",
                    "engine.import", "handoff.claim"},
        "resume": {"engine.resume"},
        "driver_die": {"engine.driver_restart", "engine.resume"}}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_event_parity(params, name):
    res = _run(name, params)
    ref, port = _norm(res["ref"][0]), _norm(res["port"][0])
    _same_outputs(res["port"][2], res["ref"][2])
    assert [k for k, _ in port] == [k for k, _ in ref]
    assert port == ref
    assert MUST[name] <= {k for k, _ in port}, (name, port)
    if name == "spec":
        assert all(a.get("spec") for k, a in port
                   if k == "engine.dispatch")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_metric_parity(params, name):
    res = _run(name, params)
    ref, port = res["ref"][1], res["port"][1]
    assert port == ref
    touched = {k for k, _ in port}
    assert {"engine_dispatches", "engine_tokens", "engine_pages_free",
            "engine_queue_depth", "engine_slot_occupancy"} <= touched or \
        name == "handoff", touched
    want = {"greedy": {"requests_expired", "engine_attn_kernel_dispatches"},
            "sampled": {"engine_cow_copies", "engine_prefix_hits"},
            "spec": {"engine_spec_proposed", "engine_spec_accept_len"},
            "handoff": {"kv_ship_bytes", "kv_handoff",
                        "handoff_leases_reclaimed", "prefill_fallbacks"},
            "driver_die": {"engine_driver_restarts"}}.get(name, set())
    assert want <= touched, (name, touched)
    stats = res["port"][3]
    if name != "handoff":
        assert port["engine_dispatches", (("deployment", "D"),)] == \
            stats["dispatches"]
    if name == "greedy":
        assert stats["attn_kernel_dispatches"] == stats["dispatches"] > 0
    if name == "spec":
        assert stats["attn_kernel_dispatches"] == 0


def test_port_ring_replays_captured_sequence(params, tmp_path):
    """The port's real recorder, on a short run: nothing dropped or torn,
    and the ring holds the captured ``greedy`` sequence, in order."""
    want = _norm(_run("greedy", params)["port"][0])
    tev._reset_for_tests()
    try:
        rec = tev.init(str(tmp_path), proc="engine-events")
        assert rec is not None
        sc_greedy(Pkg("port", params["port"]),
                  f"evp-ring-{uuid.uuid4().hex[:8]}")
        st = tev.stats()
        assert st["dropped"] == {} and st["emitted"] == len(want)
        ring = tev.read_ring(rec.path)
    finally:
        tev._reset_for_tests()
    assert ring["torn"] == 0 and ring["proc"] == "engine-events"
    got = _norm([(e["kind"], e["attrs"]) for e in ring["events"]])
    assert got == want


# ------------------------------------------------------------ stats() keys
@pytest.mark.parametrize("paged", [True, False])
def test_stats_keys_match_reference(params, paged):
    """The port's ``stats()`` keys are the reference's but ``sanitizer``
    (``queued``, ``events`` and ``attn_kernel_dispatches`` included, and
    on a flat engine none of the paged keys); the paged engines after one
    request."""
    keys = {}
    for name in ("ref", "port"):
        pkg = Pkg(name, params[name])
        eng = pkg.engine(f"evk-{uuid.uuid4().hex[:8]}", paged=paged)
        if paged:
            _, keys[name] = _serve(pkg, eng, [(_prompt(20, 6), 5, {})])
        else:
            keys[name] = eng.stats()
            eng.shutdown()
    ref, port = keys["ref"], keys["port"]
    assert set(port) == set(ref) - {"sanitizer"}
    assert set(port["handoff"]) == set(ref["handoff"])
    assert port["events"] == ref["events"] == {"enabled": False}
    assert port["queued"] == port["queue_depth"] == 0
    assert ("attn_kernel_dispatches" in port) == paged
    if paged:
        assert port["tokens"] == ref["tokens"] == 5
        assert port["attn_kernel_dispatches"] == \
            ref["attn_kernel_dispatches"] == port["dispatches"] > 0


# ------------------------------------------------------------ queue depth
def test_queue_depth_signal_and_gauge(params):
    """``tests/test_data_llm.py::test_queue_depth_signal_and_gauge`` on
    the port: the backlog shows in ``stats()`` as ``queue_depth`` and
    ``queued``, and the driver exports it as the port's
    ``serve_engine_queue_depth`` gauge."""
    dep = f"qd_probe-{uuid.uuid4().hex[:8]}"
    eng = Pkg("port", params["port"]).engine(dep, auto_start=True,
                                             paged=False)
    try:
        eng.inject_fault("driver_slow", wedge_s=0.05)
        prompt = np.arange(8, dtype=np.int32) % T32.vocab_size
        streams = [eng.stream(prompt, 8, seed=i) for i in range(6)]
        deadline = time.time() + 5
        seen = 0
        while time.time() < deadline:
            seen = max(seen, eng.queue_depth())
            st = eng.stats()
            assert st["queue_depth"] == st["queued"]
            if seen >= 2:
                break
            time.sleep(0.01)
        assert seen >= 2, "backlog never formed behind the slow driver"
        eng.inject_fault("driver_slow", wedge_s=0.0)
        for s in streams:
            list(s)
        assert eng.queue_depth() == 0
        deadline = time.time() + 5
        key = (("deployment", dep),)
        while time.time() < deadline:
            vals = dict(tserve_metrics()["engine_queue_depth"].collect())
            if vals.get(key) == 0:
                break
            time.sleep(0.02)
        assert vals.get(key) == 0, vals
        assert key not in dict(
            jserve_metrics()["engine_queue_depth"].collect())
    finally:
        eng.shutdown()


# ------------------------------------------------------- data.block_commit
def test_block_commit_events_match_reference(params):
    """``BatchInferencer`` over 3 blocks in both packages: the
    ``data.block_commit`` events are equal."""
    rows = [{"rid": i, "prompt": _prompt(30 + i, 5 + i)} for i in range(7)]
    blocks = [TB.rows_to_block(rows[i:i + 3]) for i in range(0, 7, 3)]
    commits = {}
    for name, llm, mods in (("ref", jllm, (jengine, jllm, jev)),
                            ("port", tllm, (tengine, tllm, tev))):
        eng = Pkg(name, params[name]).engine(
            f"evb-{uuid.uuid4().hex[:8]}", auto_start=True)
        try:
            with pytest.MonkeyPatch.context() as mp:
                cap = _capture(mp, *mods)
                out = list(llm.BatchInferencer(eng, max_new=5,
                                               seed=2).run(blocks))
        finally:
            eng.shutdown()
        assert len(out) == 3
        commits[name] = [a for k, a in cap.events
                         if k == "data.block_commit"]
    assert commits["port"] == commits["ref"]
    assert [c["block"] for c in commits["port"]] == [0, 1, 2]
    assert [c["rows"] for c in commits["port"]] == [3, 3, 1]
    assert all(c["tokens"] == 5 * c["rows"] and c["journaled"] is False
               for c in commits["port"])
