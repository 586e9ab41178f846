"""The runtime halves of the port's metrics and tracing planes held
against the reference's:

- ``_private/metrics.py``: per-process registry snapshots (two
  processes' worth, one with a histogram of other bounds) merged at the
  head, rendered as Prometheus text, put on the wire and summarised
  give the same results in both packages, and the core instrument set
  has the reference's names;
- ``util/tracing.py``: the submit and execute spans a runtime task
  records around its hop (``on_submit`` in the caller, ``execute_span``
  around the user code under the wire meta's ``trace_ctx``) and a
  ``manual_span`` finished elsewhere give the same spans and parenting.

Each tracing case swaps both modules' buffers for fresh ones and sets
their flags through ``monkeypatch``, so the process-wide state is
restored.
"""
from collections import deque

import pytest

from ray_tpu._private import metrics as jmetrics
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch._private import metrics as tmetrics
from ray_tpu_torch.util import tracing as ttracing
from torch_threads import one_torch_thread  # noqa: F401

TRACING = {"ref": jtracing, "port": ttracing}


def _snapshots(m):
    out = []
    for bounds, shift in (((0.1, 1.0), 0.0), ((0.5, 2.0), 0.3)):
        reg = m.MetricsRegistry()
        c = m.Counter("jobs_total", "Jobs run", registry=reg)
        g = m.Gauge("queue_depth", "Queued", registry=reg)
        h = m.Histogram("wait_seconds", "Wait", bounds=bounds,
                        registry=reg)
        c.inc(2, labels={"kind": 'a"b\n'})
        c.inc(1, labels={"kind": "plain"})
        g.set(5 + shift)
        for x in (0.05, 0.7, 1.5, 3.0):
            h.observe(x + shift)
        out.append(reg.snapshot())
    return out


def test_head_merge_and_exposition_match_reference():
    got = {}
    for name, m in (("ref", jmetrics), ("port", tmetrics)):
        merged = m.merge_snapshots(_snapshots(m))
        wire = m.merged_to_wire(merged)
        got[name] = (m.render_prometheus(merged), wire,
                     m.histogram_summary(wire, "wait_seconds"),
                     sorted((k, i.name, i.kind)
                            for k, i in m.core_metrics().items()))
    assert got["port"] == got["ref"]
    text = got["port"][0]
    assert 'bounds_conflict="1"' in text and '\\"' in text
    assert "ray_tpu_jobs_total" in text


@pytest.fixture
def fresh(monkeypatch):
    """Both tracing modules with an empty buffer, no drops counted,
    tracing on unless told off."""
    def make(enabled=True):
        for mod in TRACING.values():
            monkeypatch.setattr(mod, "_buffer", deque(
                maxlen=mod._buffer.maxlen))
            monkeypatch.setattr(mod, "_dropped", 0)
            monkeypatch.setattr(mod, "_enabled", enabled)
    return make


def _normalise(spans):
    """Spans with their ids replaced by the order of first sight."""
    ids = {}

    def name(x):
        return None if x is None else ids.setdefault(x, len(ids))

    return [{"name": s["name"], "kind": s["kind"], "status": s["status"],
             "attrs": s.get("attrs"), "trace": name(s["trace_id"]),
             "id": name(s["span_id"]), "parent": name(s["parent_id"])}
            for s in spans]


def test_task_hop_spans_match_reference(fresh):
    fresh()
    got = {}
    for pkg, mod in TRACING.items():
        with mod.span("request"):
            wire = mod.on_submit("f")
            ms = mod.manual_span("stream", kind="server", route="/x")
        with mod.execute_span({"trace_ctx": wire}, "f") as ex:
            with mod.span("inner"):
                pass
        with mod.execute_span({}, "untraced") as none:
            assert none is None
        with pytest.raises(KeyError):
            with mod.execute_span({"trace_ctx": wire}, "g"):
                raise KeyError("x")
        with ms.activate():
            child = mod.on_submit("h")
        ms.finish()
        ms.finish("error")              # a second finish records nothing
        assert ex["trace_id"] == wire["trace_id"]
        assert child["trace_id"] == wire["trace_id"]
        got[pkg] = _normalise(mod.drain())
    assert got["port"] == got["ref"]
    assert [s["name"] for s in got["port"]] == [
        "submit f", "request", "inner", "execute f", "execute g",
        "submit h", "stream"]
    assert [s["status"] for s in got["port"]][4] == "error"


def test_nothing_opened_when_off(fresh):
    """Off and with no active context, ``on_submit`` and
    ``manual_span`` give None and record nothing, in both packages."""
    fresh(enabled=False)
    for mod in TRACING.values():
        assert mod.on_submit("f") is None
        assert mod.manual_span("m") is None
        assert mod.drain() == []
