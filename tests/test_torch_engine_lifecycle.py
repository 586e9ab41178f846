"""The port engine's lifecycle and config plane, on the CPU at nano size
with an f32 compute dtype, held to the reference's behaviour.

- ``inject_fault`` (all four kinds) and ``supervise``: a driver death or
  wedge fails the running lanes with the retryable
  ``EngineRestartError``; ``supervise`` restarts the driver once (a new
  pool, the drafter reset, the epoch moved) and reports False at the
  next death; a ``resume_from`` replay after the restart is the
  reference's uninterrupted stream, at temperature 0 and seeded 0.8, on
  paged and flat pools.
- Epochs: a driver wedged inside a dispatch while the supervisor
  restarts past it drops its result when it wakes; it touches neither
  the new pool nor the new lanes.
- ``drain``: True when running lanes finish in time (queued ones and new
  submissions fail with ``EngineShutdownError``), False when they do not.
- ``ensure_paging``/``apply_config``/``ensure_spec``/``ensure_role``/
  ``ensure_tp``: as ``tests/test_serve_engine_paged.py`` (``:380-404``)
  and ``tests/test_serve_engine_spec.py`` (``:464-479``) require of the
  reference.
- The three deadline paths of the port's engine (queued for admission,
  parked for pages, mid-generation), each against the reference engine
  driven through the same steps.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import gpt_decode as jgd
from ray_tpu.serve import request as jrequest
from ray_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve.request import RequestDeadlineExceeded
from ray_tpu_torch.serve.engine import (DecodeEngine, EngineRestartError,
                                        EngineShutdownError)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J32 = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
T32 = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
KW = dict(slots=2, chunk=4, max_len=64, prompt_buckets=(8, 16))
# An injected driver death re-raises in the driver thread, as the
# reference's does: the thread's exception is the fault, not a failure.
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")


@pytest.fixture(scope="module")
def jax_params():
    return jgpt.init_params(jax.random.PRNGKey(0), J32)


@pytest.fixture(scope="module")
def torch_params():
    return tgpt.init_params(T32, 0, device="cpu")


def _engine(params, **kw):
    kw = {**KW, **kw}
    if kw.get("paged", True):
        kw.setdefault("attn_kernel", "gather")
    return DecodeEngine(params, T32, device="cpu", **kw)


def _prompt(rid: int, n: int = 8) -> np.ndarray:
    return np.random.default_rng(900 + rid).integers(
        0, J32.vocab_size, (n,)).astype(np.int32)


def _ref_stream(jax_params, prompt, max_new, temperature=0.0, seed=0):
    kw = dict(chunk=4, max_len=64)
    if temperature:
        kw.update(temperature=temperature, rng=jax.random.PRNGKey(seed))
    return np.concatenate([s[0] for s in jgd.generate_chunked(
        jax_params, prompt[None], J32, max_new, **kw)])


def _wait_restart(eng, n: int = 1, timeout: float = 10.0):
    """Probe like a replica's health check until the supervisor has
    restarted ``n`` times (the lanes fail before the dying thread is
    gone, so an early probe can still see it alive)."""
    deadline = time.monotonic() + timeout
    while eng.stats()["driver_restarts"] < n:
        assert eng.supervise()
        assert time.monotonic() < deadline, "supervisor never restarted"
        time.sleep(0.02)


def _partial(eng, prompt, max_new, seed):
    toks = []
    try:
        for c in eng.stream(prompt, max_new, seed=seed):
            toks.extend(int(t) for t in np.asarray(c).ravel())
    except EngineRestartError:
        pass
    return toks


# ------------------------------------------------- faults and restarts
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_driver_death_restart_resume_identity(jax_params, torch_params,
                                              paged, temperature):
    """Mid-stream driver death; the supervisor restarts the driver once;
    the client resubmits with ``resume_from`` and the joined stream is
    the uninterrupted one. A second death makes ``supervise`` report
    False."""
    eng = _engine(torch_params, paged=paged, page_size=8,
                  temperature=temperature, wedge_timeout_s=2.0)
    prompt = _prompt(8)
    try:
        want = _ref_stream(jax_params, prompt, 24, temperature, 11)
        old_epoch = eng._epoch
        eng.inject_fault("driver_die", at_tokens=8)
        toks = _partial(eng, prompt, 24, 11)
        assert 0 < len(toks) < 24, toks
        _wait_restart(eng)
        assert eng._epoch == old_epoch + 1
        tail = list(eng.stream(prompt, 24, seed=11, resume_from=len(toks)))
        toks.extend(int(t) for t in np.concatenate(tail))
        assert toks == [int(t) for t in want], (toks, want)
        st = eng.stats()
        assert st["driver_restarts"] == 1 and st["resumed"] == 1
        assert st["driver_alive"] and not st["draining"]
        # The second death exhausts max_driver_restarts=1.
        eng.inject_fault("driver_die", at_tokens=0)
        with pytest.raises(EngineRestartError):
            list(eng.stream(prompt, 8, seed=1))
        eng._thread.join(timeout=5)
        assert eng.supervise() is False
    finally:
        eng.shutdown()


def test_wedge_detected_and_restarted(jax_params, torch_params):
    """A driver that stops beating (``driver_wedge``) is restarted by
    ``supervise``; when the wedged thread wakes it exits without
    touching the new driver's state, and the engine serves on."""
    eng = _engine(torch_params, wedge_timeout_s=0.3)
    prompt = _prompt(9)
    try:
        want = _ref_stream(jax_params, prompt, 20)
        eng.inject_fault("driver_wedge", at_tokens=4, wedge_s=1.5)
        old = eng._thread
        got = {}

        def consume():
            got["toks"] = _partial(eng, prompt, 20, 0)

        t = threading.Thread(target=consume)
        t.start()
        deadline = time.monotonic() + 10
        while eng.stats()["driver_restarts"] == 0:
            assert eng.supervise()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        t.join(timeout=10)
        toks = got["toks"]
        assert 0 < len(toks) < 20
        old.join(timeout=5)
        assert not old.is_alive() and eng.stats()["driver_alive"]
        tail = np.concatenate(list(eng.stream(prompt, 20,
                                              resume_from=len(toks))))
        assert toks + [int(x) for x in tail] == [int(x) for x in want]
        st = eng.stats()
        assert st["pages_free"] + st["pages_used"] == st["n_pages"]
    finally:
        eng.shutdown()


def test_stale_dispatch_dropped_after_restart(jax_params, torch_params):
    """A driver stuck INSIDE a dispatch (no heartbeat) is restarted past;
    when its dispatch returns, the epoch guard drops the result: no
    token reaches a lane, no counter moves, the new pool and lanes are
    untouched."""
    eng = _engine(torch_params, wedge_timeout_s=0.2)
    prompt = _prompt(10)
    release = threading.Event()
    entered = threading.Event()
    real_step = eng._step

    def stuck_step(*a, **kw):
        entered.set()
        release.wait(10)
        return real_step(*a, **kw)

    eng._step = stuck_step
    try:
        lane_err = {}

        def consume():
            try:
                list(eng.stream(prompt, 12))
            except EngineRestartError as e:
                lane_err["e"] = e

        t = threading.Thread(target=consume)
        t.start()
        assert entered.wait(10)
        old = eng._thread
        deadline = time.monotonic() + 10
        while eng.stats()["driver_restarts"] == 0:
            assert eng.supervise()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        t.join(timeout=10)
        assert "e" in lane_err
        # The restart bound a fresh step to a fresh pool.
        assert eng._step is not stuck_step
        before = eng.stats()
        release.set()
        old.join(timeout=10)
        assert not old.is_alive()
        after = eng.stats()
        assert after["dispatches"] == before["dispatches"]
        assert after["tokens"] == before["tokens"]
        assert after["active_slots"] == 0
        assert after["pages_free"] == before["pages_free"]
        out = np.concatenate(list(eng.stream(prompt, 12)))
        np.testing.assert_array_equal(out, _ref_stream(jax_params, prompt,
                                                       12))
    finally:
        release.set()
        eng.shutdown()


def test_spec_engine_restart_resets_drafter(jax_params, torch_params):
    """A restart rebuilds the pool and resets the drafter: a resumed
    model-drafter stream equals the uninterrupted greedy one."""
    eng = _engine(torch_params, spec_decode="model", draft_k=3)
    prompt = _prompt(11)
    try:
        want = _ref_stream(jax_params, prompt, 20)
        eng.inject_fault("driver_die", at_tokens=6)
        toks = _partial(eng, prompt, 20, 0)
        _wait_restart(eng)
        tail = np.concatenate(list(eng.stream(prompt, 20,
                                              resume_from=len(toks))))
        assert toks + [int(x) for x in tail] == [int(x) for x in want]
    finally:
        eng.shutdown()


def test_supervise_ignores_stopped_or_unstarted(torch_params):
    eng = _engine(torch_params, auto_start=False)
    assert eng.supervise()                   # never started
    eng.start()
    assert eng.supervise()                   # alive and beating
    eng.shutdown()
    assert eng.supervise()                   # deliberately stopped
    assert eng.stats()["driver_restarts"] == 0
    with pytest.raises(ValueError, match="unknown fault kind"):
        eng.inject_fault("bogus")


def test_driver_slow_throttles_without_wedging(torch_params):
    eng = _engine(torch_params, wedge_timeout_s=1.0)
    try:
        eng.inject_fault("driver_slow", wedge_s=0.02)
        t0 = time.monotonic()
        out = np.concatenate(list(eng.stream(_prompt(12), 9)))
        assert out.shape == (9,) and time.monotonic() - t0 >= 0.04
        assert eng.supervise() and eng.stats()["driver_restarts"] == 0
    finally:
        eng.shutdown()


_KILL_CHILD = r"""
import numpy as np
from ray_tpu_torch.models import gpt
from ray_tpu_torch.serve.engine import DecodeEngine
cfg = gpt.CONFIGS["nano"]
eng = DecodeEngine(gpt.init_params(cfg, 0, device="cpu"), cfg, slots=2,
                   chunk=4, max_len=64, prompt_buckets=(8, 16),
                   device="cpu")
eng.inject_fault("kill_process", at_tokens=2)
for piece in eng.stream(np.arange(5, dtype=np.int32), 12):
    print("piece", len(piece), flush=True)
print("SURVIVED")
"""


def test_kill_process_fault_exits_43():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _KILL_CHILD], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 43, res.stderr[-2000:]
    assert "SURVIVED" not in res.stdout


# ---------------------------------------------------------------- drain
def test_drain_finishes_running_lanes(jax_params, torch_params):
    """``drain`` stops admissions now (a new submission and the queued
    request fail with ``EngineShutdownError``), the running lane
    finishes token-identically, and it returns True."""
    eng = _engine(torch_params, slots=1)
    prompt = _prompt(13)
    try:
        eng.inject_fault("driver_slow", wedge_s=0.02)
        running = eng.stream(prompt, 24)
        first = next(running)
        queued = eng.stream(_prompt(14), 6)
        done = {}
        t = threading.Thread(target=lambda: done.setdefault(
            "ok", eng.drain(timeout_s=20)))
        t.start()
        time.sleep(0.05)
        with pytest.raises(EngineShutdownError):
            eng.submit(prompt, 4)
        with pytest.raises(EngineShutdownError):
            list(queued)
        rest = list(running)
        t.join(timeout=30)
        assert done["ok"] is True
        np.testing.assert_array_equal(np.concatenate([first] + rest),
                                      _ref_stream(jax_params, prompt, 24))
        assert eng.stats()["draining"]
    finally:
        eng.shutdown()


def test_drain_times_out_and_fails_stragglers(torch_params):
    eng = _engine(torch_params)
    try:
        eng.inject_fault("driver_slow", wedge_s=0.05)
        running = eng.stream(_prompt(15), 40)
        next(running)
        assert eng.drain(timeout_s=0.2) is False
        with pytest.raises(EngineShutdownError, match="drained"):
            list(running)
    finally:
        eng.shutdown()


# --------------------------------------------------------- config plane
def test_ensure_paging(jax_params, torch_params):
    """``test_serve_engine_paged.py::test_ensure_paging_and_decorator_
    knobs``: an unused flat engine repages; a no-op repeats; the prefix
    cache toggles on the host; the stream equals a flat engine's; a used
    engine refuses to repage. The kernel/int8 knobs are paged only."""
    eng = _engine(torch_params, paged=False)
    try:
        assert not eng.paged
        with pytest.raises(ValueError, match="paged-pool knobs"):
            eng.ensure_paging(kv_dtype="int8")
        with pytest.raises(ValueError, match="paged-pool knobs"):
            eng.ensure_paging(attn_kernel="cuda")
        eng.ensure_paging(page_size=8, prefix_cache=True)
        assert eng.paged and eng.page_size == 8
        assert eng._prefix is not None
        assert eng.attn_kernel == "cuda"      # the port's paged default
        eng.ensure_paging(page_size=8)          # idempotent no-op
        eng.ensure_paging(prefix_cache=False)   # host-side toggle
        assert eng._prefix is None
        eng.ensure_paging(kv_dtype="int8", attn_kernel="gather")
        assert eng.kv_dtype == "int8" and "ks" in eng._cache
        eng.ensure_paging(kv_dtype="fp")
        prompt = np.arange(8, dtype=np.int32) % J32.vocab_size
        ref = _engine(torch_params, paged=False)
        try:
            want = np.concatenate(list(ref.stream(prompt, 6)))
        finally:
            ref.shutdown()
        got = np.concatenate(list(eng.stream(prompt, 6)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _ref_stream(jax_params, prompt,
                                                       6))
        with pytest.raises(ValueError, match="live engine"):
            eng.ensure_paging(page_size=16)
        with pytest.raises(ValueError, match="live engine"):
            eng.ensure_paging(kv_dtype="int8")
        with pytest.raises(ValueError, match="page_size must be"):
            eng.ensure_paging(page_size=0)
    finally:
        eng.shutdown()


def test_apply_config_spec(torch_params):
    """``test_serve_engine_spec.py`` ``:464-479`` against the port."""
    eng = _engine(torch_params, spec_decode=None)
    try:
        assert eng._verify is None
        eng.apply_config(spec_decode="ngram", draft_k=3)
        assert eng._drafter is not None and eng.draft_k == 3
        assert eng._verify is not None
        prompt = np.arange(8, dtype=np.int32) % J32.vocab_size
        list(eng.stream(prompt, 6))
        eng.apply_config(spec_decode="ngram", draft_k=3)
        with pytest.raises(ValueError, match="live engine"):
            eng.ensure_spec(draft_k=5)
        with pytest.raises(ValueError, match="live engine"):
            eng.ensure_spec(spec_decode=False)
        with pytest.raises(ValueError, match="live engine"):
            eng.ensure_spec(spec_threshold=2.0)
        with pytest.raises(ValueError, match="unknown engine config"):
            eng.apply_config(bogus=1)
        with pytest.raises(ValueError, match="draft_k"):
            eng.ensure_spec(draft_k=0)
    finally:
        eng.shutdown()


def test_apply_config_routes_tp_paging_and_role(torch_params):
    eng = _engine(torch_params, paged=False)
    try:
        eng.apply_config(tp=1, page_size=None, role=None)   # no-ops
        assert not eng.paged and eng.role == "both"
        # tp applies on an unused engine (engine.py:856), and back.
        eng.apply_config(tp=2)
        assert eng.tp == 2 and eng.stats()["tp"] == 2
        eng.apply_config(tp=1)
        assert eng.tp == 1 and eng.stats()["tp"] == 1
        eng.ensure_tp(None)
        eng.apply_config(page_size=8, role="decode", handoff_ttl_s=3.0)
        assert eng.paged and eng.page_size == 8
        assert eng.role == "decode" and eng._leases.ttl_s == 3.0
        assert eng.stats()["role"] == "decode"
        eng.apply_config(role="both")
        list(eng.stream(np.arange(5, dtype=np.int32), 3))
        with pytest.raises(ValueError, match="live engine"):
            eng.apply_config(tp=2)                  # a live engine refuses
    finally:
        eng.shutdown()


def test_stats_shape(torch_params):
    eng = _engine(torch_params)
    try:
        st = eng.stats()
        assert st["role"] == "both" and st["draining"] is False
        assert st["driver_restarts"] == 0
        assert set(st["handoff"]) == {
            "exported", "imported", "import_fallbacks", "ship_bytes",
            "leases_outstanding", "leases_claimed", "leases_reclaimed"}
    finally:
        eng.shutdown()


# ------------------------------------------------------------ deadlines
def _lane_events(lane):
    out = []
    while not lane.q.empty():
        out.append(lane.q.get_nowait())
    return out


def _errors(events):
    return [v for k, v in events if k == "err"]


def test_deadline_expired_while_queued(jax_params, torch_params):
    """An already-expired request fails at admission, without a prefill,
    in both engines."""
    for eng, exc in ((_engine(torch_params, auto_start=False),
                      RequestDeadlineExceeded),
                     (JaxEngine(jax_params, J32, auto_start=False, **KW),
                      jrequest.RequestDeadlineExceeded)):
        try:
            lane = eng.submit(_prompt(16), 6, deadline_s=time.time() - 1)
            eng._admit_pending()
            (err,) = _errors(_lane_events(lane))
            assert isinstance(err, exc) and "while queued" in str(err)
            st = eng.stats()
            assert st["expired"] == 1 and st["prefills"] == 0
        finally:
            eng.shutdown()


def test_deadline_passed_mid_generation(jax_params, torch_params):
    """Driven step by step: the lane delivers its first token and one
    chunk, then its deadline passes and the next dispatch fails it and
    frees its slot, in both engines alike."""
    results = []
    for eng in (_engine(torch_params, auto_start=False, page_size=8),
                JaxEngine(jax_params, J32, auto_start=False, paged=True,
                          page_size=8, **KW)):
        try:
            lane = eng.submit(_prompt(17), 20, deadline_s=time.time() + 60)
            eng._admit_pending()
            eng._dispatch_chunk()
            items = [v for k, v in _lane_events(lane) if k == "item"]
            eng._state[0].deadline_s = time.time() - 1
            eng._dispatch_chunk()
            (err,) = _errors(_lane_events(lane))
            assert "mid-generation" in str(err)
            st = eng.stats()
            results.append((np.concatenate(items), st["expired"],
                            st["active_slots"], st["pages_used"]))
        finally:
            eng.shutdown()
    (t_items, *t_rest), (j_items, *j_rest) = results
    np.testing.assert_array_equal(t_items, j_items)
    assert t_rest == j_rest and t_rest[0] == 1 and t_rest[1] == 0


def test_deadline_passed_while_parked(jax_params, torch_params):
    """A lane parked for pages whose deadline passes is culled at the
    next coverage pass, its pages freed to the running lane, in both
    engines alike: 8 pages of 8; slot 0 (prompt 8) parks at position 20
    while slot 1 (prompt 36) still fits; then slot 0's deadline
    passes."""
    results = []
    mk = dict(page_size=8, n_pages=8, prefix_cache=False,
              prompt_buckets=(8, 16, 64))
    for eng in (_engine(torch_params, auto_start=False, **mk),
                JaxEngine(jax_params, J32, auto_start=False, paged=True,
                          **{**KW, **mk})):
        try:
            a = eng.submit(_prompt(18, 8), 40, deadline_s=time.time() + 60)
            b = eng.submit(_prompt(19, 36), 24)
            eng._admit_pending()
            for _ in range(3):
                eng._dispatch_chunk()
            assert eng._state[0].parked and not eng._state[1].parked
            assert eng.stats()["lane_parks"] == 1
            eng._state[0].deadline_s = time.time() - 1
            eng._dispatch_chunk()
            (err,) = _errors(_lane_events(a))
            assert "parked" in str(err)
            assert eng._state[0] is None and not eng._state[1].parked
            st = eng.stats()
            b_items = [v for k, v in _lane_events(b) if k == "item"]
            results.append((np.concatenate(b_items), st["expired"],
                            st["pages_used"], st["preempted"]))
        finally:
            eng.shutdown()
    (t_b, *t_rest), (j_b, *j_rest) = results
    np.testing.assert_array_equal(t_b, j_b)
    assert t_rest == j_rest and t_rest[0] == 1 and t_rest[2] == 0
