"""The metrics plane: typed instruments in a process-local registry, the
runtime's snapshot merge and Prometheus exposition, the core and serve
instrument sets, under the reference's names, descriptions, label keys
and histogram bounds (``ray_tpu/_private/metrics.py``).

A copy of the reference's module but for ``EMA`` (the autoscaler's) and
the naming lint ``lint_metric_name``, which the reference loads from
``tools/rtlint/metrics_names.py`` and the port keeps as its own copy.
The registry warns once per name on a lint problem, and raises instead
under ``RT_METRICS_STRICT=1``, as the reference's does. Every worker
ships :meth:`MetricsRegistry.snapshot` to the head with its task events;
the head merges them (:func:`merge_snapshots`) and serves
:func:`render_prometheus` at the dashboard's ``/metrics``. The exposition
prefix stays ``ray_tpu``, so a scrape reads the same series names from
either package.

The port's registry is its own: instruments the port touches never
reach the reference's registry, and the other way round.

Conventions follow Prometheus: ``_total`` on counters, seconds for
durations, labels as a sorted tuple of ``(key, value)`` pairs.
"""
from __future__ import annotations

import contextlib
import os
import re
import threading
import time
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelPairs = Tuple[Tuple[str, str], ...]

#: Prometheus metric-name grammar (data model spec).
METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: A histogram whose name suggests it measures time must carry the
#: canonical ``_seconds`` unit suffix.
DURATION_HINTS = ("duration", "latency", "wait", "elapsed", "_time",
                  "ttft", "tpot")


def lint_metric_name(name: str, kind: str) -> List[str]:
    """Prometheus naming-convention problems for an instrument, or []."""
    problems = []
    if not METRIC_NAME_RE.match(name):
        problems.append(
            f"metric name {name!r} does not match the prometheus naming "
            f"regex {METRIC_NAME_RE.pattern}")
    if kind == "counter" and not name.endswith("_total"):
        problems.append(
            f"counter {name!r} must end in '_total' (prometheus counter "
            f"convention)")
    if kind == "histogram" and not name.endswith("_seconds") and \
            any(h in name for h in DURATION_HINTS):
        problems.append(
            f"duration histogram {name!r} must end in '_seconds' "
            f"(prometheus base-unit convention)")
    return problems


def _labels(kv: Optional[Dict[str, str]]) -> LabelPairs:
    return tuple(sorted((kv or {}).items()))


class _Instrument:
    kind = ""

    def __init__(self, name: str, description: str = "",
                 registry: "MetricsRegistry" = None):
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        (registry or global_registry()).register(self)


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name, description="", registry=None):
        super().__init__(name, description, registry)
        self._values: Dict[LabelPairs, float] = {}

    def inc(self, value: float = 1.0, labels: Optional[Dict] = None):
        key = _labels(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def collect(self) -> List[Tuple[LabelPairs, float]]:
        with self._lock:
            return list(self._values.items())


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name, description="", registry=None):
        super().__init__(name, description, registry)
        self._values: Dict[LabelPairs, float] = {}

    def set(self, value: float, labels: Optional[Dict] = None):
        with self._lock:
            self._values[_labels(labels)] = float(value)

    def collect(self):
        with self._lock:
            return list(self._values.items())


class Histogram(_Instrument):
    kind = "histogram"
    DEFAULT_BOUNDS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)

    def __init__(self, name, description="", bounds: Iterable[float] = (),
                 registry=None):
        super().__init__(name, description, registry)
        self.bounds = tuple(bounds) or self.DEFAULT_BOUNDS
        # labels -> [bucket counts..., +inf count, sum, n]
        self._values: Dict[LabelPairs, list] = {}

    @contextlib.contextmanager
    def timer(self, labels: Optional[Dict] = None):
        """Observe the block's wall time in seconds."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0, labels)

    def observe(self, value: float, labels: Optional[Dict] = None):
        key = _labels(labels)
        with self._lock:
            ent = self._values.get(key)
            if ent is None:
                ent = [0] * (len(self.bounds) + 1) + [0.0, 0]
                self._values[key] = ent
            for i, b in enumerate(self.bounds):
                if value <= b:
                    ent[i] += 1
                    break
            else:
                ent[len(self.bounds)] += 1
            ent[-2] += value
            ent[-1] += 1

    def collect(self):
        with self._lock:
            return [(k, list(v)) for k, v in self._values.items()]


class MetricsRegistry:
    def __init__(self, strict: Optional[bool] = None):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        # Naming lint: warn by default, raise in strict mode.
        if strict is None:
            strict = os.environ.get("RT_METRICS_STRICT", "").lower() in (
                "1", "true", "yes", "on")
        self.strict = strict
        self._linted: set = set()

    def register(self, inst: _Instrument):
        problems = lint_metric_name(inst.name, inst.kind)
        if problems and self.strict:
            raise ValueError("; ".join(problems))
        with self._lock:
            existing = self._instruments.get(inst.name)
            if existing is not None and existing.kind != inst.kind:
                raise ValueError(
                    f"metric {inst.name!r} already registered as "
                    f"{existing.kind}")
            first_sight = inst.name not in self._linted
            self._linted.add(inst.name)
            self._instruments[inst.name] = inst
        if problems and first_sight:
            for p in problems:
                warnings.warn(p, stacklevel=3)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)


    def snapshot(self) -> dict:
        """Wire-format snapshot: shipped from workers to the head."""
        out = {}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            out[inst.name] = {
                "kind": inst.kind, "description": inst.description,
                "bounds": list(getattr(inst, "bounds", ())),
                "values": [(list(k), v) for k, v in inst.collect()],
            }
        return out

_global: Optional[MetricsRegistry] = None
_global_lock = threading.Lock()


def global_registry() -> MetricsRegistry:
    global _global
    with _global_lock:
        if _global is None:
            _global = MetricsRegistry()
        return _global


# ------------------------------------------------------------- serve set
def merge_snapshots(snaps: List[dict]) -> dict:
    """Head-side merge of per-process snapshots (sum counters/histograms,
    last-writer-wins gauges).

    Two processes reporting DIFFERENT ``bounds`` for the same histogram
    name (a rolling deploy changed the buckets, or two libraries collide
    on a name) cannot be element-wise summed — the old code's ``zip``
    silently truncated the longer list, corrupting every count. Such
    snapshots now merge into separate sub-series kept under the entry's
    ``bounds_conflict`` list (one per distinct bounds tuple) and render
    with a ``bounds_conflict`` label so no sample is lost or miscounted."""
    merged: dict = {}
    for snap in snaps:
        for name, data in snap.items():
            ent = merged.setdefault(name, {
                "kind": data["kind"], "description": data["description"],
                "bounds": data.get("bounds", []), "values": {}})
            values = ent["values"]
            if data["kind"] == "histogram" and \
                    list(data.get("bounds", [])) != list(ent["bounds"]):
                sub = None
                for c in ent.setdefault("bounds_conflict", []):
                    if c["bounds"] == list(data.get("bounds", [])):
                        sub = c
                        break
                if sub is None:
                    sub = {"bounds": list(data.get("bounds", [])),
                           "values": {}}
                    ent["bounds_conflict"].append(sub)
                values = sub["values"]
            for key_list, v in data["values"]:
                key = tuple(tuple(p) for p in key_list)
                if data["kind"] == "counter":
                    values[key] = values.get(key, 0.0) + v
                elif data["kind"] == "gauge":
                    values[key] = v
                else:  # histogram: element-wise sum (bounds match here)
                    cur = values.get(key)
                    values[key] = (
                        [a + b for a, b in zip(cur, v)] if cur else list(v))
    return merged


def escape_label_value(v) -> str:
    """Prometheus exposition escaping for a label value: backslash,
    double-quote, and line-feed must be escaped or the line is invalid."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(s: str) -> str:
    """HELP text escaping (backslash and line-feed per the spec)."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def render_prometheus(merged: dict, prefix: str = "ray_tpu") -> str:
    """Merged snapshot → prometheus text exposition format."""
    lines: List[str] = []

    def fmt_labels(key: LabelPairs, extra: str = "") -> str:
        parts = [f'{k}="{escape_label_value(v)}"' for k, v in key]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render_hist(full, key, bounds, v, extra_pair=None):
        base_key = key if extra_pair is None else key + (extra_pair,)
        cum = 0
        for i, b in enumerate(bounds):
            cum += v[i]
            # No backslash inside the f-string expression:
            # pre-3.12 interpreters reject it at compile time.
            le = f'le="{b}"'
            lines.append(f"{full}_bucket{fmt_labels(base_key, le)} {cum}")
        cum += v[len(bounds)]
        le_inf = 'le="+Inf"'
        lines.append(f"{full}_bucket{fmt_labels(base_key, le_inf)} {cum}")
        lines.append(f"{full}_sum{fmt_labels(base_key)} {v[-2]}")
        lines.append(f"{full}_count{fmt_labels(base_key)} {v[-1]}")

    for name in sorted(merged):
        ent = merged[name]
        full = f"{prefix}_{name}"
        if ent["description"]:
            lines.append(
                f"# HELP {full} {_escape_help(ent['description'])}")
        lines.append(f"# TYPE {full} {ent['kind']}")
        for key, v in sorted(ent["values"].items()):
            if ent["kind"] in ("counter", "gauge"):
                lines.append(f"{full}{fmt_labels(key)} {v}")
            else:
                render_hist(full, key, ent["bounds"], v)
        # Series whose processes reported different bucket bounds render
        # separately, marked by a bounds_conflict label (summing them
        # would corrupt every count).
        for i, sub in enumerate(ent.get("bounds_conflict", [])):
            pair = ("bounds_conflict", str(i + 1))
            for key, v in sorted(sub["values"].items()):
                render_hist(full, key, sub["bounds"], v, extra_pair=pair)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- core set
# Instantiated lazily so importing this module stays cheap.
_core: dict = {}


def core_metrics() -> dict:
    if not _core:
        _core.update(
            tasks_finished=Counter(
                "tasks_finished_total", "Tasks executed on this worker"),
            task_duration=Histogram(
                "task_duration_seconds", "Task execution wall time"),
            objects_stored=Gauge(
                "object_store_objects", "Objects in the memory store"),
            shm_bytes=Gauge(
                "object_store_shm_bytes", "Bytes in shared-memory store"),
            actors_alive=Gauge("actors_alive", "Live actors (head view)"),
            workers_alive=Gauge("workers_alive", "Live workers (head view)"),
            leases_granted=Counter(
                "leases_granted_total", "Worker leases granted by the head"),
            objects_recovered=Counter(
                "objects_recovered_total",
                "Lost objects rebuilt via lineage re-execution"),
            oom_workers_killed=Counter(
                "oom_workers_killed_total",
                "Workers killed by the memory monitor under host "
                "memory pressure"),
        )
    return _core


# Label conventions: ``deployment`` names the deployment (an engine's
# ``deployment``); ``where`` names the layer that dropped or degraded the
# request (the port's engine says ``engine``).
_serve: dict = {}
_serve_lock = threading.Lock()

#: Sub-second-biased bounds for per-token latency (TPOT).
_TOKEN_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)
_BATCH_SIZE_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
_RATIO_BOUNDS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


def serve_metrics() -> dict:
    """The serve instrument set, built once per process in the port's
    registry. The port's engine touches the ``engine_*``, ``kv_*``,
    ``handoff_leases_reclaimed``, ``prefill_fallbacks`` and
    ``requests_expired`` instruments, and its flight recorder
    ``events_dropped``; the rest belong to the serve front and stay at
    zero here."""
    with _serve_lock:
        if _serve:
            return _serve
        _serve.update(
            requests_shed=Counter(
                "serve_requests_shed_total",
                "Requests shed under overload (backpressure / 503)"),
            events_dropped=Counter(
                "rt_events_dropped_total",
                "Flight-recorder events dropped by per-kind rate caps "
                "(labelled by kind; the ring survived a storm)"),
            requests_expired=Counter(
                "serve_requests_expired_total",
                "Requests dropped because their deadline passed before "
                "execution"),
            retries=Counter(
                "serve_request_retries_total",
                "Budgeted request retries after replica failure"),
            overload_repicks=Counter(
                "serve_overload_repicks_total",
                "Replica overload pushbacks answered by re-picking "
                "another replica"),
            e2e_latency=Histogram(
                "serve_request_e2e_seconds",
                "End-to-end request latency observed at the caller "
                "(submission to result, or to stream exhaustion)"),
            ttft=Histogram(
                "serve_ttft_seconds",
                "Time from stream submission to the first item "
                "(time-to-first-token)"),
            tpot=Histogram(
                "serve_tpot_seconds",
                "Per-token inter-chunk latency of streamed responses "
                "(time-per-output-token)", bounds=_TOKEN_BOUNDS),
            queue_wait=Histogram(
                "serve_queue_wait_seconds",
                "Time a request waited before dispatch, by layer "
                "(where=router: admission wait; where=replica: "
                "submission-to-admission transit)"),
            batch_wait=Histogram(
                "serve_batch_wait_seconds",
                "Time a request waited in the @serve.batch queue before "
                "its batch flushed"),
            batch_size=Histogram(
                "serve_batch_size",
                "Observed (pre-padding) batch sizes at flush",
                bounds=_BATCH_SIZE_BOUNDS),
            batch_fill_ratio=Histogram(
                "serve_batch_fill_ratio",
                "Observed batch size / max_batch_size at flush",
                bounds=_RATIO_BOUNDS),
            # ---- continuous-batching engine: observed on the engine's
            # driver thread, once per dispatch / admission.
            engine_slot_occupancy=Histogram(
                "serve_engine_slot_occupancy",
                "Active-slot fraction of the continuous-batching decode "
                "engine, observed per fused dispatch",
                bounds=_RATIO_BOUNDS),
            engine_admission_wait=Histogram(
                "serve_engine_admission_wait_seconds",
                "Time a request waited in the engine admission queue "
                "before its slot prefill"),
            engine_dispatches=Counter(
                "serve_engine_dispatches_total",
                "Fused decode dispatches issued by the slot engine"),
            engine_tokens=Counter(
                "serve_engine_tokens_total",
                "Tokens emitted to engine stream lanes"),
            engine_queue_depth=Gauge(
                "serve_engine_queue_depth",
                "Requests accepted by the engine but not yet admitted "
                "to a slot (admission backlog), set once per driver "
                "loop — the offline batch-inference throttle signal"),
            # ---- speculative decoding: once per draft->verify round.
            engine_spec_proposed=Counter(
                "serve_engine_spec_proposed_total",
                "Draft tokens proposed to the verify step "
                "(draft_k per active slot per round)"),
            engine_spec_accepted=Counter(
                "serve_engine_spec_accepted_total",
                "Draft tokens the target accepted at verification"),
            engine_spec_accept_len=Histogram(
                "serve_engine_spec_accept_len",
                "Per-slot accepted draft length per verify round "
                "(0..draft_k; committed tokens are this + 1)",
                bounds=(0, 1, 2, 3, 4, 6, 8, 12, 16)),
            # ---- paged KV pool: as the allocator hands pages out.
            engine_pages_free=Gauge(
                "serve_engine_pages_free",
                "KV pages on the paged engine's free list"),
            engine_kv_bytes_per_token=Gauge(
                "serve_engine_kv_bytes_per_token",
                "HBM bytes one KV-cache position costs under the "
                "engine's configured kv_dtype (int8 pages carry codes "
                "plus amortized per-page scales)"),
            engine_attn_kernel_dispatches=Counter(
                "serve_engine_attn_kernel_dispatches_total",
                "Fused decode dispatches that ran the paged-attention "
                "kernel path (attn_kernel=pallas) instead of the XLA "
                "gather reference"),
            engine_pages_used=Gauge(
                "serve_engine_pages_used",
                "KV pages held by live lanes or the prefix cache"),
            engine_prefix_hits=Counter(
                "serve_engine_prefix_hits_total",
                "Admissions that mapped a cached prompt prefix instead "
                "of prefilling it"),
            engine_cow_copies=Counter(
                "serve_engine_cow_copies_total",
                "Copy-on-write page forks (cached prefix ended "
                "mid-page)"),
            # ---- crash-safe streaming.
            stream_resumes=Counter(
                "serve_stream_resumes_total",
                "Mid-stream failovers: streams re-routed to another "
                "replica with a deterministic replay token after a "
                "replica/driver failure"),
            engine_driver_restarts=Counter(
                "serve_engine_driver_restarts_total",
                "Engine driver threads restarted by the supervisor "
                "after a death or wedge (first occurrence; a second "
                "escalates to replica replacement)"),
            replica_drains=Counter(
                "serve_replica_drains_total",
                "Graceful replica drains (admissions stopped, running "
                "lanes finished or failed retryably) before teardown"),
            drain_duration=Histogram(
                "serve_drain_duration_seconds",
                "Wall time of graceful replica drains"),
            # ---- disaggregated prefill/decode.
            kv_handoff=Histogram(
                "serve_kv_handoff_seconds",
                "Prefill->decode KV handoff latency: export stamp to "
                "successful import on the decode engine"),
            kv_ship_bytes=Counter(
                "serve_kv_ship_bytes_total",
                "KV bytes exported into handoff ship buffers"),
            handoff_leases_reclaimed=Counter(
                "serve_handoff_leases_reclaimed_total",
                "Handoff leases that expired unclaimed (the decode "
                "side died or fell back); their shipped pages were "
                "swept"),
            prefill_fallbacks=Counter(
                "serve_prefill_fallbacks_total",
                "Disaggregated requests that degraded to a local "
                "prefill (where=router: no prefill replica answered; "
                "where=engine: shipped payload unavailable or failed "
                "byte verification)"),
            # ---- SLO-driven autoscaler.
            autoscale_decisions=Counter(
                "serve_autoscale_decisions_total",
                "Autoscaler decisions applied, by direction (up | "
                "down); labels carry deployment and role group"),
            autoscale_held=Counter(
                "serve_autoscale_held_total",
                "Autoscaler ticks that degraded to a conservative hold, "
                "by reason (stale_signal | missing_signal | cold_start "
                "| cooldown | stabilizing | idle_wait)"),
        )
        return _serve


def merged_to_wire(merged: dict) -> dict:
    """Merged snapshot → RPC-safe form (tuple label keys become lists,
    mirroring ``MetricsRegistry.snapshot``'s wire format)."""
    out = {}
    for name, ent in merged.items():
        w = {"kind": ent["kind"], "description": ent["description"],
             "bounds": list(ent["bounds"]),
             "values": [(list(list(p) for p in k), v)
                        for k, v in ent["values"].items()]}
        if ent.get("bounds_conflict"):
            w["bounds_conflict"] = [
                {"bounds": list(sub["bounds"]),
                 "values": [(list(list(p) for p in k), v)
                            for k, v in sub["values"].items()]}
                for sub in ent["bounds_conflict"]]
        out[name] = w
    return out


def quantile_from_buckets(bounds: Sequence[float], counts: Sequence[float],
                          q: float) -> Optional[float]:
    """Quantile estimate from cumulative-free bucket counts (the wire
    layout: one count per bound plus the +Inf overflow). Linear
    interpolation inside the winning bucket, like PromQL's
    ``histogram_quantile``; the +Inf bucket clamps to the last bound."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    lower = 0.0
    for i, b in enumerate(bounds):
        prev = cum
        cum += counts[i]
        if cum >= target:
            frac = (target - prev) / max(counts[i], 1e-12)
            return lower + (b - lower) * min(max(frac, 0.0), 1.0)
        lower = b
    return float(bounds[-1]) if bounds else None


def histogram_summary(wire: dict, metric: str,
                      label_filter: Optional[Dict[str, str]] = None,
                      qs: Sequence[float] = (0.5, 0.95, 0.99)
                      ) -> Optional[dict]:
    """p50/p95/p99 (+count/sum) for one histogram in a wire-format merged
    snapshot, summing every label set matching ``label_filter``. Returns
    None when the metric is absent or has no observations."""
    ent = wire.get(metric)
    if ent is None or ent.get("kind") != "histogram":
        return None
    want = set((label_filter or {}).items())
    bounds = ent.get("bounds", [])
    agg: Optional[List[float]] = None
    for key_list, v in ent.get("values", []):
        if not want <= {(p[0], p[1]) for p in key_list}:
            continue
        agg = [a + b for a, b in zip(agg, v)] if agg else list(v)
    if agg is None or agg[-1] <= 0:
        return None
    buckets = agg[:len(bounds) + 1]
    out = {f"p{int(q * 100)}_s": quantile_from_buckets(bounds, buckets, q)
           for q in qs}
    out["count"] = agg[-1]
    out["mean_s"] = agg[-2] / agg[-1]
    # Differing-bounds sub-series cannot join one quantile computation;
    # surface what the quantiles above do NOT cover instead of silently
    # dropping those observations from the summary.
    excluded = 0
    for sub in ent.get("bounds_conflict", []):
        for key_list, v in sub.get("values", []):
            if want <= {(p[0], p[1]) for p in key_list}:
                excluded += v[-1]
    if excluded:
        out["excluded_bounds_conflict_count"] = excluded
    return out


def now() -> float:
    return time.time()
