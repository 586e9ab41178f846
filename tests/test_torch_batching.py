"""The port's request batcher (``ray_tpu_torch/serve/batching.py``) held
against the reference's ``ray_tpu/serve/batching.py``, in-process (both
decorators run without a cluster):

- ``tests/test_serve_engine.py::test_batch_buckets_must_cover_max_batch_size``
  on both packages;
- bucketed padding: the handler sees only bucket sizes and each caller
  gets its own result;
- the flush-time drop of an entry whose deadline passed while it was
  queued (``tests/test_serve_overload.py::test_expired_entry_dropped_at_batcher``,
  without the cluster), counted under ``requests_expired{where="batcher"}``;
- ``stream=True`` with one caller abandoning its stream, and with both
  abandoning (the handler stops);
- ``continuous=True`` over each package's engine (nano f32, the port's
  bit-equal draw of the reference's weights): a plain request, a
  ``resume_from`` replay and the ``"export"`` → descriptor hop pair give
  equal tokens, and the deadline and trace context reach the engine.

Each scenario runs once per package with the same callers, each inside a
``request`` span and a request context (deadline, deployment) set the
way a replica sets it. Flushes are made deterministic by a handler that
holds its batch until the next callers have queued. The handler's
batches, the callers' results, the ``batch.wait`` spans (names,
parents, attributes) and the deltas of the three batch histograms and
``requests_expired`` must be the reference's.
"""
import dataclasses
import threading
import time
import uuid
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.serve.batching as jbatching
import ray_tpu.serve.engine as jengine
import ray_tpu.serve.request as jrequest
from ray_tpu._private.metrics import serve_metrics as jserve_metrics
from ray_tpu.models import gpt as jgpt
from ray_tpu.util import tracing as jtracing
import ray_tpu_torch.serve.batching as tbatching
import ray_tpu_torch.serve.engine as tengine
import ray_tpu_torch.serve.request as trequest
from ray_tpu_torch._private.metrics import serve_metrics as tserve_metrics
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.util import tracing as ttracing
from torch_threads import one_torch_thread  # noqa: F401

J32 = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
T32 = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
ENGINE_KW = dict(slots=2, chunk=4, max_len=64, prompt_buckets=(16,),
                 paged=True, page_size=8)
#: Series compared as deltas; timing histograms by count alone.
BATCH_METRICS = ("batch_size", "batch_fill_ratio", "batch_wait",
                 "requests_expired")
TIMING = ("batch_wait",)


@dataclasses.dataclass
class Pkg:
    name: str
    batching: object
    request: object
    tracing: object
    serve_metrics: object


PKGS = {"ref": Pkg("ref", jbatching, jrequest, jtracing, jserve_metrics),
        "port": Pkg("port", tbatching, trequest, ttracing, tserve_metrics)}


@pytest.fixture
def spans(monkeypatch):
    """Tracing on, with fresh span buffers, in both packages for the
    test."""
    for p in PKGS.values():
        monkeypatch.setattr(p.tracing, "_buffer", deque(maxlen=10_000))
        monkeypatch.setattr(p.tracing, "_enabled", True)
    return {k: p.tracing for k, p in PKGS.items()}


def in_request(pkg, fn, arg, *, deployment, deadline=None, **ctx):
    """Call ``fn(arg)`` the way a replica runs user code: the request
    context set, inside a ``request`` span. Returns (result or the
    exception raised, the span's wire context)."""
    r = pkg.request
    tokens = [(r._request_deployment, r._request_deployment.set(deployment)),
              (r._request_deadline, r._request_deadline.set(deadline))]
    for name, value in ctx.items():
        var = getattr(r, f"_request_{name}")
        tokens.append((var, var.set(value)))
    try:
        with pkg.tracing.span("request") as sp:
            try:
                return fn(arg), sp
            except Exception as e:  # noqa: BLE001 - the caller's outcome
                return e, sp
    finally:
        for var, tok in reversed(tokens):
            var.reset(tok)


class Callers:
    """Caller threads of one scenario, each a request; ``out[i]`` is
    caller i's (result, span context)."""

    def __init__(self, pkg, fn, deployment):
        self.pkg, self.fn, self.dep = pkg, fn, deployment
        self.out, self.threads = {}, []

    def start(self, i, arg, **kw):
        def run():
            self.out[i] = in_request(self.pkg, self.fn, arg,
                                     deployment=self.dep, **kw)
        t = threading.Thread(target=run, daemon=True)
        t.start()
        self.threads.append(t)

    def join(self):
        for t in self.threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in self.threads)


def _metrics(pkg, dep):
    """{(key, labels): value} of the batch instruments under ``dep``."""
    sm, out = pkg.serve_metrics(), {}
    for key in BATCH_METRICS:
        for labels, v in sm[key].collect():
            if ("deployment", dep) in labels:
                out[key, labels] = v
    return out


def _deltas(before, after):
    out = {}
    for k, v in after.items():
        old = before.get(k)
        if isinstance(v, list):
            d = [a - b for a, b in zip(v, old or [0] * len(v))]
            if d[-1]:
                out[k] = d[-1] if k[0] in TIMING else d[:-2] + [d[-1]]
        elif v - (old or 0.0):
            out[k] = v - (old or 0.0)
    return out


def _span_view(spans, ctxs):
    """The batcher's and engine's spans with parents named by caller and
    the timings checked, then dropped."""
    by_span = {c["span_id"]: i for i, c in ctxs.items() if c}
    out = []
    for s in spans:
        if s["name"] == "request":
            continue
        assert s["end"] >= s["start"] > 0 and s["status"] == "ok", s
        assert s["trace_id"] == ctxs[by_span[s["parent_id"]]]["trace_id"]
        out.append((s["name"], s["kind"], by_span[s["parent_id"]],
                    s.get("attrs")))
    return out


def _held(queue_of, entered, expect):
    """A handler body for ``_BatchQueue``-driven scenarios: batch k
    signals ``entered[k]``, then waits until ``expect[k]`` more callers
    have queued, so the next flush takes exactly those."""
    def hold(k):
        entered[k].set()
        if k < len(expect):
            t_end = time.time() + 20
            while queue_of().q.qsize() < expect[k]:
                assert time.time() < t_end, "callers never queued"
                time.sleep(0.002)
    return hold


def _run_padded(pkg, dep):
    """1 caller, then 3, then 5 through
    ``batch(max_batch_size=8, pad_to_bucket=True)``: the handler sees 1,
    4 and 8 items."""
    entered = [threading.Event() for _ in range(3)]

    class Model:
        def __init__(self):
            self.seen, self.ctxs = [], []

        @pkg.batching.batch(max_batch_size=8, batch_wait_timeout_s=0.05,
                            pad_to_bucket=True)
        def predict(self, xs):
            k = len(self.seen)
            self.seen.append(list(xs))
            self.ctxs.append(pkg.tracing.current_context())
            hold(k)
            return [x * 10 for x in xs]

    m = Model()
    hold = _held(lambda: m.__dict__["__rt_batch_queue_predict"], entered,
                 [3, 5])
    callers = Callers(pkg, m.predict, dep)
    callers.start(0, 1)
    entered[0].wait(20)
    for i in range(1, 4):
        callers.start(i, 1 + i)
    entered[1].wait(20)
    for i in range(4, 9):
        callers.start(i, 1 + i)
    callers.join()
    return m, callers


def test_pad_to_bucket_matches_reference(spans):
    got, dep = {}, f"bpad-{uuid.uuid4().hex[:8]}"
    for name, pkg in PKGS.items():
        before = _metrics(pkg, dep)
        m, callers = _run_padded(pkg, dep)
        got[name] = (m, callers, _deltas(before, _metrics(pkg, dep)),
                     pkg.tracing.drain())
    views = {}
    for name, (m, callers, deltas, sp) in got.items():
        out = callers.out
        assert [len(b) for b in m.seen] == [1, 4, 8]
        assert set(map(len, m.seen)) <= set(
            PKGS[name].batching.default_buckets(8))
        assert {i: r for i, (r, _) in out.items()} == \
            {i: (1 + i) * 10 for i in range(9)}
        ctxs = {i: c for i, (_, c) in out.items()}
        # The lead (first traced) caller of each batch parents the
        # handler's spans.
        assert m.ctxs[0] == ctxs[0]
        assert m.__dict__["__rt_batch_queue_predict"].batch_sizes == \
            [1, 3, 5]
        views[name] = (sorted(_span_view(sp, ctxs), key=lambda v: v[2]),
                       {k[0]: v for k, v in deltas.items()}, m.seen)
    assert views["port"] == views["ref"]
    span_view, deltas, seen = views["port"]
    assert [v[3]["batch_size"] for v in span_view] == [1] + [3] * 3 + [5] * 5
    assert {v[0] for v in span_view} == {"batch.wait"}
    assert deltas["batch_size"] == [1, 0, 1, 1, 0, 0, 0, 0, 0, 0, 3]
    assert deltas["batch_wait"] == 9 and "requests_expired" not in deltas
    assert seen[1] == [2, 3, 4, 4]           # padded with the last item


def test_expired_entry_dropped_at_flush(spans):
    """Caller 0 holds the handler while A (deadline 50 ms away) and B
    (none) queue; A's deadline passes before the next flush, which fails
    A and runs B alone."""
    got, dep = {}, f"bexp-{uuid.uuid4().hex[:8]}"
    for name, pkg in PKGS.items():
        entered = [threading.Event() for _ in range(2)]
        deadline = {}

        class Batched:
            def __init__(self):
                self.sizes = []

            @pkg.batching.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
            def predict(self, xs):
                self.sizes.append(len(xs))
                hold(len(self.sizes) - 1)
                if len(self.sizes) == 1:
                    while time.time() <= deadline["a"]:
                        time.sleep(0.005)
                return [x * 2 for x in xs]

        b = Batched()
        hold = _held(lambda: b.__dict__["__rt_batch_queue_predict"],
                     entered, [2])
        before = _metrics(pkg, dep)
        callers = Callers(pkg, b.predict, dep)
        callers.start(0, 5)
        entered[0].wait(20)
        deadline["a"] = pkg.request.make_deadline(0.05)
        callers.start(1, 1, deadline=deadline["a"])
        callers.start(2, 2, deadline=pkg.request.make_deadline(30.0))
        callers.join()
        out = callers.out
        assert b.sizes == [1, 1], b.sizes
        assert isinstance(out[1][0], pkg.request.RequestDeadlineExceeded)
        assert isinstance(out[1][0], TimeoutError)
        assert (out[0][0], out[2][0]) == (10, 4)
        ctxs = {i: c for i, (_, c) in out.items()}
        got[name] = (sorted(_span_view(pkg.tracing.drain(), ctxs),
                            key=lambda v: v[2]),
                     {k[0]: v for k, v in _deltas(
                         before, _metrics(pkg, dep)).items()})
    assert got["port"] == got["ref"]
    span_view, deltas = got["port"]
    assert [(v[2], v[3]["batch_size"]) for v in span_view] == [(0, 1),
                                                               (2, 1)]
    assert deltas["requests_expired"] == 1
    assert deltas["batch_size"] == [2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2]


@pytest.mark.parametrize("both_leave", [False, True])
def test_stream_abandon_matches_reference(spans, both_leave):
    """Two callers in one ``stream=True`` batch. Caller 0 takes one
    slice and closes its stream; caller 1 reads on to the end, or
    (``both_leave``) closes too and the handler stops after the slice in
    flight, its cleanup run."""
    got, dep = {}, f"bstr-{uuid.uuid4().hex[:8]}"
    for name, pkg in PKGS.items():
        gate = threading.Event()
        left, lock = [0], threading.Lock()
        log = []

        class Gen:
            @pkg.batching.batch(max_batch_size=2, batch_wait_timeout_s=5.0,
                                stream=True)
            def tokens(self, xs):
                try:
                    for k in range(5):
                        log.append(k)
                        yield [x * 100 + k for x in xs]
                        if k == 0:
                            gate.wait(20)
                finally:
                    log.append("closed")

        def consume(it):
            want = 1 if (it[0] == 0 or both_leave) else None
            stream = g.tokens(it[1])
            out = []
            for piece in stream:
                out.append(piece)
                if want is not None and len(out) == want:
                    break
            stream.close()
            with lock:
                left[0] += 1
                if left[0] == (2 if both_leave else 1):
                    gate.set()
            return out

        g = Gen()
        before = _metrics(pkg, dep)
        callers = Callers(pkg, consume, dep)
        callers.start(0, (0, 1))
        callers.start(1, (1, 2))
        callers.join()
        t_end = time.time() + 10
        while "closed" not in log:
            assert time.time() < t_end, "the handler was never closed"
            time.sleep(0.005)
        got[name] = (sorted((i, r) for i, (r, _) in callers.out.items()),
                     log, len(_span_view(pkg.tracing.drain(), {
                         i: c for i, (_, c) in callers.out.items()})),
                     {k[0]: v for k, v in _deltas(
                         before, _metrics(pkg, dep)).items()})
    assert got["port"] == got["ref"]
    results, log, n_spans, deltas = got["port"]
    first = sorted(r[0] // 100 for _, r in results)
    assert n_spans == 2 and deltas["batch_size"][1] == 1
    if both_leave:
        assert log == [0, 1, "closed"] and all(len(r) == 1
                                                for _, r in results)
    else:
        assert log == [0, 1, 2, 3, 4, "closed"]
        long = [r for _, r in results if len(r) == 5]
        assert len(long) == 1 and long[0] == [
            long[0][0] + k for k in range(5)]
    assert first == [1, 2]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_batch_buckets_must_cover_max_batch_size(pkg):
    """``tests/test_serve_engine.py:312``: custom buckets that cannot
    hold a full batch are a decorate-time ValueError, not a silent
    negative-count 'pad'; engine knobs need ``continuous=True``."""
    batch = PKGS[pkg].batching.batch

    with pytest.raises(ValueError, match="do not cover"):
        @batch(max_batch_size=8, pad_to_bucket=True, buckets=(2, 4))
        def bad(items):
            return items

    with pytest.raises(ValueError, match="positive"):
        @batch(max_batch_size=4, buckets=(0, 4))
        def worse(items):
            return items

    @batch(max_batch_size=8, pad_to_bucket=True, buckets=(2, 4, 8))
    def good(items):
        return items

    with pytest.raises(ValueError, match="continuous=True"):
        @batch(continuous=True, stream=True)
        def conflicted(item):
            return item

    with pytest.raises(ValueError, match="require continuous=True"):
        @batch(page_size=8)
        def knob(item):
            return item

    @batch(continuous=True)
    def not_a_pair(item):
        return item

    with pytest.raises(TypeError, match="must return"):
        not_a_pair(1)
    assert good.__rt_is_batched__ and not_a_pair.__rt_continuous__
    assert PKGS[pkg].batching.default_buckets(12) == [1, 2, 4, 8, 12]
    assert PKGS[pkg].batching.pad_to_bucket(5, [1, 2, 4, 8]) == 8


# ------------------------------------------------------------ continuous
def _prompt(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(4100 + seed).integers(
        0, J32.vocab_size, (n,)).astype(np.int32)


class Spy:
    """Records the keywords each engine entry point was called with."""

    def __init__(self, eng):
        self.calls = []
        for name in ("submit", "handoff", "admit_prefilled"):
            setattr(eng, name, self._wrap(name, getattr(eng, name)))

    def _wrap(self, name, fn):
        def call(*a, **kw):
            self.calls.append((name, kw.get("deadline_s"),
                               kw.get("trace_ctx"),
                               kw.get("resume_from")))
            return fn(*a, **kw)
        return call


def _continuous(pkg, eng, dep):
    """The plain request, its ``resume_from=3`` replay, and the export →
    import hop pair through ``batch(continuous=True, page_size=8)``."""

    class Deployment:
        @pkg.batching.batch(continuous=True, page_size=8)
        def decode(self, request):
            return eng, {"prompt": request["prompt"],
                         "max_new": request["max_new"], "seed": 0}

    d = Deployment()

    def stream(req):
        out = d.decode(req)
        if isinstance(out, dict):
            return out                       # the prefill hop's descriptor
        return np.concatenate(list(out))

    deadline = pkg.request.make_deadline(120.0)
    a, b = {"prompt": _prompt(0, 7), "max_new": 10}, \
        {"prompt": _prompt(1, 12), "max_new": 8}
    res = [in_request(pkg, stream, a, deployment=dep, deadline=deadline,
                      id="rq-a")]
    res.append(in_request(pkg, stream, a, deployment=dep,
                          deadline=deadline, resume_from=3, id="rq-a"))
    res.append(in_request(pkg, stream, b, deployment=dep,
                          deadline=deadline, handoff="export", id="rq-b"))
    desc = res[-1][0]
    assert isinstance(desc, dict), desc
    res.append(in_request(pkg, stream, b, deployment=dep,
                          deadline=deadline, handoff=desc, id="rq-b"))
    return res, deadline


def test_continuous_matches_reference(spans):
    port = tgpt.init_params(T32, 0, device="cpu")
    ref = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                 tgpt.params_tree(port))
    got, dep = {}, f"bcont-{uuid.uuid4().hex[:8]}"
    for name, pkg in PKGS.items():
        if name == "port":
            eng = tengine.DecodeEngine(port, T32, device="cpu",
                                       deployment=dep, **ENGINE_KW)
        else:
            eng = jengine.DecodeEngine(ref, J32, deployment=dep,
                                       **ENGINE_KW)
        spy = Spy(eng)
        try:
            res, deadline = _continuous(pkg, eng, dep)
            stats = eng.stats()
        finally:
            eng.shutdown()
        ctxs = dict(enumerate(c for _, c in res))
        for (entry, dl, tctx, resume), c in zip(spy.calls, ctxs.values()):
            assert dl == deadline and tctx == c, (entry, dl, tctx)
        got[name] = ([r for r, _ in res[:2]] + [res[3][0]],
                     [(c[0], c[3]) for c in spy.calls],
                     _span_view(pkg.tracing.drain(), ctxs),
                     stats["handoff"]["imported"])
    (p_toks, p_calls, p_spans, p_imp), (r_toks, r_calls, r_spans, r_imp) = \
        got["port"], got["ref"]
    for x, y in zip(p_toks, r_toks):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(p_toks[1], p_toks[0][3:])
    assert p_calls == r_calls == [("submit", 0), ("submit", 3),
                                  ("handoff", None),
                                  ("admit_prefilled", 0)]
    assert p_spans == r_spans
    assert p_imp == r_imp == 1
    names = [(s[0], s[2]) for s in p_spans]
    assert names.count(("engine.admission", 0)) == 1
    assert ("engine.admission", 2) in names
    assert [s[3].get("imported") for s in p_spans
            if s[0] == "engine.admission"] == [None, None, None, True]
    # decode.chunk tokens add up to each stream's tokens after the first.
    for i, n in ((0, 10), (1, 10), (3, 8)):
        assert sum(s[3]["tokens"] for s in p_spans
                   if s[0] == "decode.chunk" and s[2] == i) == n - 1
