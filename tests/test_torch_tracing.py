"""The port's span recorder (``ray_tpu_torch/util/tracing.py``) held
against the reference's ``ray_tpu/util/tracing.py``: the same script of
``span``/``record_span``/``activate_context``/``current_context`` calls
leaves spans with the same keys, names, kinds, statuses, attributes and
parenting; nothing records while tracing is off and no context is
active; and at a small buffer both count the same drops, which move
their ``tracing_spans_dropped_total`` counters by the same amount.

Each test swaps both modules' buffers for fresh ones and sets their
flags through ``monkeypatch``, so the process-wide state is restored.
"""
from collections import deque

import pytest

from ray_tpu._private import metrics as jmetrics
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch._private import metrics as tmetrics
from ray_tpu_torch.util import tracing as ttracing
from torch_threads import one_torch_thread  # noqa: F401

MODS = {"ref": jtracing, "port": ttracing}
REGISTRIES = {"ref": jmetrics.global_registry, "port":
              tmetrics.global_registry}
WIRE = {"trace_id": "ab" * 16, "span_id": "cd" * 8}
#: Spans the script records with ``record_span`` and its own stamps.
RECORDED = {"stage", "wired", "under", "orphan"}
KEYS = {"name", "kind", "trace_id", "span_id", "parent_id", "start", "end",
        "status"}


@pytest.fixture
def fresh(monkeypatch):
    """Both modules with an empty buffer of ``maxlen`` (default: the
    module's own), no drops counted, tracing on unless told off."""
    def make(maxlen=None, enabled=True):
        for mod in MODS.values():
            monkeypatch.setattr(mod, "_buffer", deque(
                maxlen=maxlen or mod._buffer.maxlen))
            monkeypatch.setattr(mod, "_dropped", 0)
            monkeypatch.setattr(mod, "_enabled", enabled)
    return make


def _script(mod):
    """One scripted use of the API; returns the drained spans and the
    contexts it saw."""
    seen = [mod.current_context()]
    with mod.span("root", user="alice") as root:
        seen.append(mod.current_context() == root)
        ctx = mod.current_context()
        with mod.span("child", kind="client"):
            mod.record_span("stage", 1.0, 2.0, k=1)
        mod.record_span("wired", 3.0, 4.0, parent_ctx=ctx, kind="queue",
                        status="error", x=2)
    seen.append(mod.current_context())
    with mod.activate_context(WIRE) as got:
        seen.append(got == mod.current_context() == WIRE)
        mod.record_span("under", 5.0, 6.0, slot=3)
        with mod.span("nested"):
            pass
    with mod.activate_context(None) as got:
        seen.append(got)
    with pytest.raises(ValueError):
        with mod.span("fails"):
            raise ValueError("boom")
    mod.record_span("orphan", 7.0, 8.0)
    return mod.drain(), seen


def _normalise(spans):
    """Spans with their ids replaced by the order of first sight and the
    clock stamps of ``span()`` replaced by a check."""
    ids = {}

    def name(x):
        return None if x is None else ids.setdefault(x, len(ids))

    out = []
    for s in spans:
        assert KEYS <= set(s) <= KEYS | {"attrs"}, s
        assert isinstance(s["start"], float) and s["end"] >= s["start"]
        d = {k: s[k] for k in ("name", "kind", "status")}
        d["trace"] = name(s["trace_id"])
        d["id"] = name(s["span_id"])
        d["parent"] = name(s["parent_id"])
        d["attrs"] = s.get("attrs")
        if s["name"] in RECORDED:       # the stamps the script gave
            d["stamps"] = (s["start"], s["end"])
        out.append(d)
    return out


def test_spans_and_parenting_match_reference(fresh):
    fresh()
    got = {k: _script(m) for k, m in MODS.items()}
    port, ref = got["port"], got["ref"]
    assert port[1] == ref[1] == [None, True, None, True, None]
    assert _normalise(port[0]) == _normalise(ref[0])
    spans = {s["name"]: s for s in port[0]}
    assert [s["name"] for s in port[0]] == [
        "stage", "child", "wired", "root", "under", "nested", "fails",
        "orphan"]
    root = spans["root"]
    assert root["parent_id"] is None and root["attrs"] == {"user": "alice"}
    assert spans["child"]["parent_id"] == root["span_id"]
    assert spans["stage"]["parent_id"] == spans["child"]["span_id"]
    assert spans["wired"]["parent_id"] == root["span_id"]
    assert spans["wired"]["status"] == "error"
    for n in ("under", "nested"):
        assert spans[n]["trace_id"] == WIRE["trace_id"]
        assert spans[n]["parent_id"] == WIRE["span_id"]
    assert spans["fails"]["status"] == "error"
    assert spans["orphan"]["parent_id"] is None
    assert spans["orphan"]["trace_id"] != root["trace_id"]
    assert "attrs" not in spans["child"]


@pytest.mark.parametrize("pkg", list(MODS))
def test_nothing_recorded_when_off(fresh, pkg):
    """Off with no context: ``span`` yields None and ``record_span``
    returns None, nothing buffered; a wire context still records (the
    decision belongs to whoever opened the trace)."""
    fresh(enabled=False)
    mod = MODS[pkg]
    with mod.span("x") as s:
        assert s is None and mod.current_context() is None
    assert mod.record_span("y", 1.0, 2.0) is None
    assert mod.local_spans() == []
    assert mod.record_span("z", 1.0, 2.0, parent_ctx=WIRE)["parent_id"] \
        == WIRE["span_id"]
    with mod.activate_context(WIRE):
        with mod.span("w") as s:
            assert s["trace_id"] == WIRE["trace_id"]
    assert [s["name"] for s in mod.drain()] == ["z", "w"]


def _dropped_counter(pkg) -> float:
    inst = REGISTRIES[pkg]().get("tracing_spans_dropped_total")
    return 0.0 if inst is None else sum(v for _, v in inst.collect())


def test_drops_match_reference(fresh):
    """A buffer of 3: five spans drop two; a drain, a requeue of four
    into a buffer holding one drops two more; the counts, what stays
    buffered and the counters' deltas are the reference's."""
    fresh(maxlen=3)
    got = {}
    for pkg, mod in MODS.items():
        c0 = _dropped_counter(pkg)
        for i in range(5):
            mod.record_span(f"s{i}", float(i), float(i) + 1)
        first = mod.dropped_total()
        kept = [s["name"] for s in mod.local_spans()]
        drained = mod.drain()
        mod.record_span("late", 9.0, 10.0)
        mod.requeue(drained + [dict(drained[0], name="extra")])
        buffered = [s["name"] for s in mod.local_spans()]
        taken = mod.take_dropped()
        mod.add_dropped(3)
        got[pkg] = (first, kept, buffered, taken, mod.dropped_total(),
                    mod.take_dropped(), mod.dropped_total(),
                    _dropped_counter(pkg) - c0)
    assert got["port"] == got["ref"]
    assert got["port"] == (2, ["s2", "s3", "s4"], ["s2", "s3", "s4"], 4,
                           3, 3, 0, 4.0)
