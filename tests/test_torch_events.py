"""The port's flight recorder and serve metrics
(``ray_tpu_torch/_private/events.py``, ``_private/metrics.py``) held
against the reference's ``ray_tpu/_private/events.py`` and
``ray_tpu/_private/metrics.py``.

- The recorder cases of ``tests/test_events.py`` on the port's module:
  round trip and wrap (the last N kept), a rate-capped storm that leaves
  the file size unchanged, a disabled recorder that touches nothing, the
  ``RT_EVENTS_DIR`` fallback, an unwritable directory that turns the
  recorder off, oversized attributes truncated to the correlation ids,
  and drops counted in the port's ``events_dropped``.
- The ring crosses packages: a ring the port writes reads back through
  the reference's ``read_ring`` with equal events, and a ring the
  reference's ``Recorder`` writes reads back through the port's.
- The registry: ``serve_metrics()`` has the reference's keys, kinds,
  names, descriptions and histogram bounds, and ``lint_metric_name``
  finds the same problems as ``tools/rtlint/metrics_names.py``.

The reference's process-wide recorder is never enabled here: its rings
are built directly on files under ``tmp_path``.
"""
import importlib.util
import os

import pytest

from ray_tpu._private import events as jev
from ray_tpu._private import metrics as jmetrics
from ray_tpu_torch._private import events as ev
from ray_tpu_torch._private import metrics as tmetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_recorder(monkeypatch):
    monkeypatch.delenv(ev.EVENTS_DIR_ENV, raising=False)
    ev._reset_for_tests()
    yield
    ev._reset_for_tests()


# ---------------------------------------------------------------- recorder
@pytest.mark.parametrize("n_slots,n_events", [(ev.DEFAULT_SLOTS, 7),
                                              (8, 20)])
def test_ring_keeps_last_n(tmp_path, n_slots, n_events):
    """Round trip below the ring's size, and a wrap that keeps the last
    ``n_slots`` events, in seq order with non-decreasing monotonic
    stamps."""
    rec = ev.Recorder(ev.ring_path(str(tmp_path), "t"), "t",
                      n_slots=n_slots)
    for i in range(n_events):
        assert rec.emit("unit.test", {"i": i, "request": f"rq-{i}"})
    rec.close()
    ring = ev.read_ring(rec.path)
    first = max(0, n_events - n_slots)
    assert ring["torn"] == 0 and ring["proc"] == "t"
    assert [e["attrs"]["i"] for e in ring["events"]] == \
        list(range(first, n_events))
    assert ring["events"][0]["seq"] == first + 1
    assert all(e["kind"] == "unit.test" for e in ring["events"])
    monos = [e["mono"] for e in ring["events"]]
    assert monos == sorted(monos)


def test_rate_cap_bounds_storm_and_file_size(tmp_path):
    """A storm cannot grow the ring file; drops are counted per kind, and
    another kind keeps its own bucket."""
    rec = ev.Recorder(ev.ring_path(str(tmp_path), "t"), "t",
                      rate_per_s=10.0)
    size0 = os.path.getsize(rec.path)
    for i in range(5000):
        rec.emit("engine.dispatch", {"i": i})
    assert os.path.getsize(rec.path) == size0
    st = rec.stats()
    assert st["dropped"]["engine.dispatch"] > 4000
    assert st["emitted"] + st["dropped_total"] == 5000
    assert rec.emit("engine.preempt", {"slot": 0})
    rec.close()


def test_disabled_is_true_noop():
    """Off: emit returns False before it looks at the attributes (a value
    whose repr or pickle raises is never touched), and no recorder or
    ring is built."""
    class Bomb:
        def __repr__(self):
            raise RuntimeError("repr touched")

        def __reduce__(self):
            raise RuntimeError("pickle touched")

    assert ev.emit("unit.noop", payload=Bomb()) is False
    assert ev.driver_emit("unit.noop", payload=Bomb()) is False
    assert ev._resolved and ev.recorder() is None and not ev.enabled()
    assert ev.stats() == {"enabled": False}


def test_init_env_fallback_and_idempotence(tmp_path, monkeypatch):
    monkeypatch.setenv(ev.EVENTS_DIR_ENV, str(tmp_path))
    assert ev.emit("unit.env", i=1)            # lazy init from the env
    rec = ev.recorder()
    assert rec is not None and ev.init() is rec and ev.enabled()
    st = ev.stats()
    assert st["enabled"] and st["emitted"] == 1
    assert [f for f in os.listdir(tmp_path) if f.endswith(".evr")] == \
        [os.path.basename(rec.path)]


def test_unwritable_dir_degrades_to_disabled(tmp_path, monkeypatch):
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    monkeypatch.setenv(ev.EVENTS_DIR_ENV, str(blocker / "events"))
    assert ev.emit("unit.bad", i=1) is False
    assert ev.stats() == {"enabled": False}


def test_oversized_attrs_truncated_but_correlated(tmp_path):
    rec = ev.Recorder(ev.ring_path(str(tmp_path), "t"), "t")
    rec.emit("unit.big", {"request": "rq-9", "epoch": 2,
                          "blob": "x" * 10000})
    rec.close()
    assert rec.truncated == 1
    (e,) = ev.read_ring(rec.path)["events"]
    assert e["attrs"] == {"request": "rq-9", "epoch": 2,
                          "truncated": True}


def test_dropped_events_feed_the_port_counter(tmp_path):
    """Drops land in the PORT's ``rt_events_dropped_total``; the
    reference's counter does not move."""
    ev.init(str(tmp_path), proc="storm", rate_per_s=5.0)
    key = (("kind", "unit.storm"),)
    mine = tmetrics.serve_metrics()["events_dropped"]
    theirs = jmetrics.serve_metrics()["events_dropped"]
    before = dict(mine.collect()).get(key, 0.0)
    before_ref = dict(theirs.collect()).get(key, 0.0)
    for i in range(200):
        ev.emit("unit.storm", i=i)
    dropped = ev.stats()["dropped"].get("unit.storm", 0)
    assert dropped > 0
    assert dict(mine.collect()).get(key, 0.0) - before == dropped
    assert dict(theirs.collect()).get(key, 0.0) == before_ref


# ------------------------------------------------------- across packages
def _events(ring):
    return [(e["seq"], e["mono"], e["wall"], e["kind"], e["attrs"])
            for e in ring["events"]]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ring_crosses_packages(tmp_path, writer):
    """The byte format is shared: either package reads the other's ring
    (a wrapped one, with a truncated record) to the same events."""
    mod = ev if writer == "port" else jev
    rec = mod.Recorder(mod.ring_path(str(tmp_path), writer), writer,
                       n_slots=16)
    for i in range(20):
        rec.emit("engine.dispatch", {"epoch": 0, "active": i % 3,
                                     "chunk": 4, "dispatch_s": 0.001 * i})
    rec.emit("engine.admit", {"request": "eng-1-1", "slot": 1,
                              "blob": "y" * 4000})
    rec.close()
    mine, theirs = ev.read_ring(rec.path), jev.read_ring(rec.path)
    assert mine == theirs
    assert mine["torn"] == 0 and mine["proc"] == writer
    assert len(mine["events"]) == 16
    assert mine["events"][-1]["attrs"] == {"request": "eng-1-1",
                                           "truncated": True}
    assert _events(mine) == _events(theirs)


# --------------------------------------------------------------- registry
def test_serve_metrics_match_reference():
    mine, theirs = tmetrics.serve_metrics(), jmetrics.serve_metrics()
    assert sorted(mine) == sorted(theirs)
    for key in theirs:
        a, b = mine[key], theirs[key]
        assert (a.kind, a.name, a.description) == \
            (b.kind, b.name, b.description), key
        assert getattr(a, "bounds", None) == getattr(b, "bounds", None), key
        assert tmetrics.global_registry().get(a.name) is a
    assert tmetrics.serve_metrics() is mine


def _tool_lint():
    spec = importlib.util.spec_from_file_location(
        "_rtlint_metrics_names",
        os.path.join(ROOT, "tools", "rtlint", "metrics_names.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lint_metric_name


NAMES = [("serve_engine_tokens_total", "counter"),
         ("serve_engine_tokens", "counter"),
         ("serve_engine_queue_depth", "gauge"),
         ("serve_kv_handoff_seconds", "histogram"),
         ("serve_kv_handoff_latency", "histogram"),
         ("serve_batch_wait", "histogram"),
         ("serve_batch_size", "histogram"),
         ("9bad-name", "counter"),
         ("bad name_total", "gauge"),
         ("ns:engine_ttft", "histogram")]


def test_lint_metric_name_matches_tool():
    lint = _tool_lint()
    for name, kind in NAMES:
        assert tmetrics.lint_metric_name(name, kind) == lint(name, kind), \
            (name, kind)
    assert sum(bool(tmetrics.lint_metric_name(n, k)) for n, k in NAMES) \
        == 6


@pytest.mark.parametrize("strict", ["1", ""])
def test_registry_lint_strict_or_warn(monkeypatch, strict):
    """``RT_METRICS_STRICT=1`` refuses a badly named instrument; without
    it the registry warns once per name and keeps it."""
    monkeypatch.setenv("RT_METRICS_STRICT", strict)
    reg = tmetrics.MetricsRegistry()
    assert reg.strict is bool(strict)
    if strict:
        with pytest.raises(ValueError, match="_total"):
            tmetrics.Counter("unit_requests", registry=reg)
        assert reg.get("unit_requests") is None
    else:
        with pytest.warns(UserWarning, match="_total"):
            tmetrics.Counter("unit_requests", registry=reg)
        c = reg.get("unit_requests")
        c.inc(2, labels={"deployment": "d"})
        assert c.collect() == [((("deployment", "d"),), 2.0)]
    h = tmetrics.Histogram("unit_wait_seconds", bounds=(0.5, 1.0),
                           registry=reg)
    for v in (0.1, 0.7, 3.0):
        h.observe(v)
    with h.timer():
        pass
    assert h.collect()[0][1][:3] == [2, 1, 1] and h.collect()[0][1][-1] == 4
    with pytest.raises(ValueError, match="already registered"):
        tmetrics.Gauge("unit_wait_seconds", registry=reg)
