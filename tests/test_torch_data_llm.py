"""The port's offline batch inference (``ray_tpu_torch.data.llm``) held
to the reference's (``ray_tpu.data.llm``) on the CPU at nano size with
an f32 compute dtype: the same weights (each package's ``init_params``
for seed 0, bit-equal) and the same row blocks from a numpy seed.

- ``BatchInferencer`` over the port's ``DecodeEngine`` against the
  reference's over its own, at temperature 0 and seeded 0.8: rows,
  order, every token and ``stats`` (but ``wall_s``) equal; ``generate``
  with a ``max_new_col`` against the reference's ``Dataset.generate``.
- ``EngineSaturationPolicy``: the reference's fake-engine cases
  (``tests/test_data_llm.py:112-134``) through both classes.
- ``ProgressLog``: a rerun on a completed log admits nothing and gives
  the same rows with their numpy types; a fingerprint mismatch, a
  heterogeneous pool and a capacity mismatch refuse; a torn block
  directory is removed on open; a changed blocking raises; a block
  committed by the reference's log loads in the port's.
- A driver death mid-run costs a replay: the output equals the
  undisturbed port run and the reference's.
- Abandonment closes every lane and leaves the engine clean and
  admissible.
- ``_EngineStream.poll`` and the ``deployment`` label as the
  reference's; ``resolve_engines``' labels, ownership and refusals.
- ``_model_fingerprint`` on bf16 and f32 parameters.

Engines and weights are built once per module; every engine runs on the
CPU (``device="cpu"``), where the paged kernel's wrapper runs its plain
version.
"""
import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import data as rd
from ray_tpu.data import llm as jllm
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import gpt_decode as jgd
from ray_tpu.serve import batching as jbatching
from ray_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_tpu_torch import data as td
from ray_tpu_torch.data import block as TB
from ray_tpu_torch.data import llm as tllm
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import batching as tbatching
from ray_tpu_torch.serve.engine import DecodeEngine
from torch_threads import one_torch_thread  # noqa: F401

J32 = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
T32 = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
KW = dict(slots=2, chunk=4, max_len=64, prompt_buckets=(8, 16))
TEMPS = (0.0, 0.8)
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


@pytest.fixture(scope="module")
def engines(jax_params, torch_params):
    """{(package, temperature): engine}, shared by the module's tests
    (each reads its own deltas of the engine's counters)."""
    out = {}
    try:
        for t in TEMPS:
            out["jax", t] = JaxEngine(jax_params, J32, temperature=t, **KW)
            out["torch", t] = DecodeEngine(torch_params, T32, temperature=t,
                                           device="cpu", **KW)
        yield out
    finally:
        for eng in out.values():
            eng.shutdown()


def _rows(n, base_seed=0, max_new_col=False):
    rng = np.random.default_rng(base_seed)
    rows = []
    for i in range(n):
        row = {"rid": int(i),
               "prompt": rng.integers(0, J32.vocab_size,
                                      (int(rng.integers(5, 17)),)
                                      ).astype(np.int32)}
        if max_new_col:
            row["n"] = 3 + i % 3
        rows.append(row)
    return rows


def _blocks(rows, size):
    return [TB.rows_to_block(rows[i:i + size])
            for i in range(0, len(rows), size)]


def _flat(blocks):
    return [r for b in blocks for r in TB.iter_rows(b)]


def _same_rows(got, want):
    assert [r["rid"] for r in got] == [r["rid"] for r in want]
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b), (a, b)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (k, a)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def _ref_chunked(jax_params, prompt, max_new):
    return np.concatenate([s[0] for s in jgd.generate_chunked(
        jax_params, np.asarray(prompt)[None], J32, max_new, chunk=4,
        max_len=64)])


# ------------------------------------------------ identity with the reference
@pytest.mark.parametrize("temperature", TEMPS)
def test_pipeline_token_identity_and_order(engines, temperature):
    """10 rows in blocks of 3, 9 new tokens each, seed 5: the port's
    pipeline gives the reference's rows in the reference's order, token
    for token, with equal accounting."""
    rows = _rows(10)
    jeng, teng = engines["jax", temperature], engines["torch", temperature]
    j_adm, t_adm = jeng.stats()["admitted"], teng.stats()["admitted"]
    jbi = jllm.BatchInferencer(jeng, max_new=9, seed=5)
    want = _flat(jbi.run(rd.from_items(rows, block_size=3)))
    tbi = tllm.BatchInferencer(teng, max_new=9, seed=5)
    got_blocks = list(tbi.run(_blocks(rows, 3)))
    assert len(got_blocks) == 4
    _same_rows(_flat(got_blocks), want)
    assert [r["rid"] for r in want] == list(range(10))
    js, ts = dict(jbi.stats), dict(tbi.stats)
    js.pop("wall_s"), ts.pop("wall_s")
    assert ts == js
    assert ts["rows"] == 10 and ts["tokens"] == 90 and ts["blocks"] == 4
    st = teng.stats()
    assert st["admitted"] - t_adm == 10 == jeng.stats()["admitted"] - j_adm
    assert st["active_slots"] == 0 and st["queue_depth"] == 0


def test_generate_matches_dataset_generate(jax_params, torch_params):
    """``generate`` over a (params, cfg) model with a per-row max_new
    column gives the reference's ``Dataset.generate`` rows, and shuts its
    engines down when exhausted."""
    rows = _rows(6, base_seed=3, max_new_col=True)
    want = rd.from_items(rows, block_size=2).generate(
        (jax_params, J32), "prompt", max_new_col="n", seed=2,
        **KW).take_all()
    got = _flat(td.generate(_blocks(rows, 2), (torch_params, T32),
                            "prompt", max_new_col="n", seed=2,
                            device="cpu", **KW))
    _same_rows(got, want)
    assert [len(r["generated"]) for r in got] == [r["n"] for r in rows]
    assert not _engine_threads("batch_gen")


# ------------------------------------------------------- saturation policy
class _Fake:
    def __init__(self, slots, depth):
        self.slots, self._d = slots, depth

    def queue_depth(self):
        return self._d


def _policy_trace(cls):
    a, b = _Fake(4, 0), _Fake(4, 5)
    pol = cls([a, b], queue_factor=2.0)          # limit 8
    names = {id(a): "a", id(b): "b", id(None): None}
    out = [pol.can_add_input(0), names[id(pol.pick())]]
    a._d = 8
    out += [names[id(pol.pick())], pol.can_add_input(0)]
    b._d = 8
    out += [names[id(pol.pick())], pol.can_add_input(0)]
    c = _Fake(1, 0)                              # limit max(1, round(0.4))
    small = cls([c], queue_factor=0.4)
    out += [small.can_add_input(0), names.get(id(small.pick()), "c")]
    c._d = 1
    out += [small.can_add_input(3), small.pick()]
    for args in (([], 2.0), ([a], 0), ([a], -1.0)):
        try:
            cls(*args)
            out.append("no error")
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def test_saturation_policy_decisions_match():
    want = _policy_trace(jllm.EngineSaturationPolicy)
    assert want[:6] == [True, "a", "b", True, None, False]
    assert _policy_trace(tllm.EngineSaturationPolicy) == want
    assert isinstance(tllm.EngineSaturationPolicy([_Fake(1, 0)]),
                      td.BackpressurePolicy)
    with pytest.raises(NotImplementedError):
        td.BackpressurePolicy().can_add_input(0)


# ----------------------------------------------------------- progress log
@pytest.fixture
def fresh_engine(torch_params):
    made = []

    def make(**kw):
        made.append(DecodeEngine(torch_params, T32, device="cpu",
                                 **{**KW, **kw}))
        return made[-1]

    yield make
    for eng in made:
        eng.shutdown()


def test_progress_log_rerun_admits_nothing(tmp_path, engines,
                                           fresh_engine):
    """A completed log satisfies a rerun with zero admissions; the rows
    come back equal, numpy types and all."""
    rows = _rows(8)
    for r in rows:
        r["tag"] = f"row{r['rid']}"
        r["w"] = np.float32(r["rid"]) / 3
    d = str(tmp_path / "progress")
    eng = engines["torch", 0.8]
    bi = tllm.BatchInferencer(eng, max_new=7, seed=1, progress_path=d)
    first = _flat(bi.run(_blocks(rows, 3)))
    assert bi.stats["blocks"] == 3
    assert tllm.ProgressLog.scan(d) == {0, 1, 2}
    eng2 = fresh_engine(temperature=0.8)
    bi2 = tllm.BatchInferencer(eng2, max_new=7, seed=1, progress_path=d)
    again = _flat(bi2.run(_blocks(rows, 3)))
    assert eng2.stats()["admitted"] == 0
    assert bi2.stats["blocks_from_log"] == 3
    assert bi2.stats["rows_resumed_from_log"] == 8
    _same_rows(again, first)
    for a, b in zip(first, again):
        for k in ("prompt", "tag", "w", "rid"):
            assert type(b[k]) is type(a[k]), k


def test_progress_log_refusals(tmp_path, engines, fresh_engine):
    """Other generation knobs on a resume, a heterogeneous pool and a
    pool whose admission capacity differs all refuse, with the
    reference's messages."""
    d = str(tmp_path / "progress")
    eng = engines["torch", 0.0]
    bi = tllm.BatchInferencer(eng, max_new=4, progress_path=d)
    list(bi.run(_blocks(_rows(2), 2)))
    with pytest.raises(ValueError, match="different generation"):
        tllm.BatchInferencer(eng, max_new=5, progress_path=d)
    hot = fresh_engine(temperature=1.0)
    with pytest.raises(ValueError, match="disagree"):
        tllm.BatchInferencer([eng, hot], max_new=4)
    short = fresh_engine(prompt_buckets=(8,))
    with pytest.raises(ValueError, match="disagree on admission capacity"):
        tllm.BatchInferencer([eng, short], max_new=4)
    jeng = engines["jax", 0.0]
    with pytest.raises(ValueError, match="disagree"):
        jllm.BatchInferencer([jeng, engines["jax", 0.8]], max_new=4)


def test_progress_log_torn_dir_and_changed_blocking(tmp_path, engines):
    """A block directory without its ``rows.npy`` is removed on open (and
    its block regenerates); a resume whose input is blocked differently
    raises instead of dropping or repeating rows."""
    rows = _rows(6, base_seed=1)
    d = str(tmp_path / "progress")
    eng = engines["torch", 0.0]
    first = _flat(tllm.BatchInferencer(eng, max_new=5, progress_path=d)
                  .run(_blocks(rows, 3)))
    os.remove(os.path.join(d, "block_000001", "rows.npy"))
    adm = eng.stats()["admitted"]
    bi = tllm.BatchInferencer(eng, max_new=5, progress_path=d)
    assert bi._log.committed() == {0}
    assert not os.path.exists(os.path.join(d, "block_000001"))
    again = _flat(bi.run(_blocks(rows, 3)))
    assert eng.stats()["admitted"] - adm == 3
    assert bi.stats["blocks_from_log"] == 1
    _same_rows(again, first)
    bi = tllm.BatchInferencer(eng, max_new=5, progress_path=d)
    with pytest.raises(ValueError, match="SAME blocking"):
        list(bi.run(_blocks(rows, 2)))


def test_progress_log_block_crosses_packages(tmp_path):
    """A block committed by the reference's ProgressLog loads in the
    port's, opened with the same fingerprint dict: equal rows and
    tokens, numpy types intact; and the other way round."""
    fp = {"model": "m", "max_new": 4, "temperature": 0.8, "seed": 3}
    rows = [{"rid": i, "prompt": np.arange(3 + i, dtype=np.int32),
             "tag": f"r{i}"} for i in range(3)]
    gen = [np.arange(4, dtype=np.int32) + 10 * i for i in range(3)]
    for src, dst in ((jllm, tllm), (tllm, jllm)):
        d = str(tmp_path / src.__name__)
        src.ProgressLog(d, fp).commit(2, rows, gen)
        log = dst.ProgressLog(d, fp)
        assert log.committed() == {2}
        got = list(TB.iter_rows(log.load(2, "generated")))
        want = [dict(r, generated=g) for r, g in zip(rows, gen)]
        _same_rows(got, want)
        assert type(got[0]["rid"]) is int and type(got[0]["tag"]) is str
        with pytest.raises(ValueError, match="different generation"):
            dst.ProgressLog(d, dict(fp, seed=4))


# ---------------------------------------------------------- faults, abandon
def test_driver_death_costs_a_replay(engines, fresh_engine):
    """``driver_die`` after 20 tokens at seeded T=0.8: the pipeline
    supervises the driver back up and replays with ``resume_from``; the
    output equals the undisturbed port run and the reference's."""
    rows = _rows(8, base_seed=2)
    want = _flat(jllm.BatchInferencer(engines["jax", 0.8], max_new=12,
                                      seed=5)
                 .run(rd.from_items(rows, block_size=4)))
    calm = _flat(tllm.BatchInferencer(engines["torch", 0.8], max_new=12,
                                      seed=5).run(_blocks(rows, 4)))
    eng = fresh_engine(temperature=0.8)
    eng.inject_fault("driver_die", at_tokens=20)
    bi = tllm.BatchInferencer(eng, max_new=12, seed=5)
    got = _flat(bi.run(_blocks(rows, 4)))
    assert eng.stats()["driver_restarts"] == 1
    assert bi.stats["retries"] >= 1
    _same_rows(calm, want)
    _same_rows(got, want)


def test_abandoned_pipeline_frees_engine(jax_params, fresh_engine):
    """Closing the generator closes every in-flight lane; the engine frees
    slots and pages at its next chunk boundary and a fresh stream still
    equals the reference's ``generate_chunked``."""
    eng = fresh_engine(page_size=8, prefix_cache=False)
    n_pages = eng.n_pages
    rows = _rows(12)
    bi = tllm.BatchInferencer(eng, max_new=40)
    gen = bi.run(_blocks(rows, 2))
    next(gen)
    assert bi._flights, "no in-flight streams to abandon"
    lanes = [fl.stream._lane for fl in bi._flights.values()]
    gen.close()
    assert all(lane.closed for lane in lanes) and not bi._flights
    deadline = time.time() + 10
    while time.time() < deadline:
        st = eng.stats()
        if st["active_slots"] == 0 and st["queue_depth"] == 0 \
                and st["pages_free"] == n_pages:
            break
        time.sleep(0.02)
    assert st["active_slots"] == 0 and st["queue_depth"] == 0, st
    assert st["pages_free"] == n_pages and st["abandoned"] >= 1, st
    prompt = rows[0]["prompt"]
    out = np.concatenate(list(eng.stream(prompt, 6)))
    assert np.array_equal(out, _ref_chunked(jax_params, prompt, 6))


# ------------------------------------------------------ poll and deployment
def _poll_trace(mod):
    """(item, end, empty, error) through ``mod``'s ``_EngineStream``."""
    out = []
    lane = mod._StreamLane()
    s = mod._EngineStream(lane)
    out.append(s.poll())
    lane.q.put(("item", np.array([4, 5], np.int32)))
    lane.q.put(("item", np.array([6], np.int32)))
    lane.q.put((mod._STREAM_END, None))
    for _ in range(4):
        evt = s.poll()
        out.append(evt if evt is None else (evt[0], None if evt[1] is None
                                            else evt[1].tolist()))
    lane = mod._StreamLane()
    s = mod._EngineStream(lane)
    lane.q.put(("item", np.array([1], np.int32)))
    lane.q.put(("err", KeyError("lane failed")))
    out.append(s.poll()[1].tolist())
    try:
        s.poll()
        out.append("no error")
    except KeyError as e:
        out.append(("KeyError", str(e)))
    s.close()
    out.append(lane.closed)
    return out


def test_poll_matches_reference():
    want = _poll_trace(jbatching)
    assert want == [None, ("item", [4, 5]), ("item", [6]), ("end", None),
                    None, [1], ("KeyError", "'lane failed'"), True]
    assert _poll_trace(tbatching) == want


def _engine_threads(label):
    return [t for t in threading.enumerate()
            if t.name.startswith(f"rt-torch-decode-engine-{label}")]


def test_deployment_label_and_resolve_engines(jax_params, torch_params,
                                              engines):
    """``stats()["deployment"]`` and the driver thread's name as the
    reference's; ``resolve_engines`` labels, ownership and refusals."""
    for label in ("", "qd_probe"):
        j = JaxEngine(jax_params, J32, deployment=label, auto_start=False,
                      **KW)
        t = DecodeEngine(torch_params, T32, deployment=label,
                         device="cpu", auto_start=False, **KW)
        assert t.stats()["deployment"] == j.stats()["deployment"] \
            == (label or "engine")
        t.shutdown()
        j.shutdown()
    assert engines["torch", 0.0]._thread.name == \
        "rt-torch-decode-engine-engine"
    for n in (1, 3):
        jl, jowned = jllm.resolve_engines((jax_params, J32), num_engines=n,
                                          auto_start=False, **KW)
        tl, towned = tllm.resolve_engines((torch_params, T32),
                                          num_engines=n, device="cpu",
                                          auto_start=False, **KW)
        try:
            assert jowned and towned
            labels = [e.stats()["deployment"] for e in tl]
            assert labels == [e.stats()["deployment"] for e in jl]
            assert len(set(labels)) == n
        finally:
            for e in jl + tl:
                e.shutdown()
    live = engines["torch", 0.0]
    assert tllm.resolve_engines(live) == ([live], False)
    assert tllm.resolve_engines([live, live]) == ([live, live], False)
    with pytest.raises(ValueError, match="only apply"):
        tllm.resolve_engines(live, slots=4)
    with pytest.raises(ValueError, match="only apply"):
        tllm.resolve_engines([live], num_engines=2)
    for bad in (object(), "model", [], (torch_params,)):
        with pytest.raises(TypeError):
            tllm.resolve_engines(bad)
        with pytest.raises(TypeError):
            jllm.resolve_engines(bad)


def test_generate_shuts_down_owned_engines_on_close(torch_params):
    """Owned engines stop when the generator closes early, and when it
    raises; live engines are left running."""
    rows = _rows(6)
    gen = td.generate(_blocks(rows, 2), (torch_params, T32), max_new=30,
                      num_engines=2, deployment="owned_probe",
                      device="cpu", **KW)
    next(gen)
    assert len(_engine_threads("owned_probe")) == 2
    gen.close()
    assert not _engine_threads("owned_probe")

    def broken():
        yield TB.rows_to_block(rows[:2])
        raise RuntimeError("upstream failed")

    gen = td.generate(broken(), (torch_params, T32), max_new=4,
                      deployment="owned_probe", device="cpu", **KW)
    with pytest.raises(RuntimeError, match="upstream failed"):
        list(gen)
    assert not _engine_threads("owned_probe")


# ------------------------------------------------------------- fingerprint
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_fingerprint(torch_params, dtype):
    """Stable across calls and copies, blind to nothing in the first 128
    elements of any leaf: one edited weight changes it, and so does the
    dtype."""
    p = {k: v.to(dtype) for k, v in torch_params.items()}
    fp = tllm._model_fingerprint(p)
    assert fp == tllm._model_fingerprint(p)
    assert fp == tllm._model_fingerprint({k: v.clone() for k, v in
                                          reversed(list(p.items()))})
    name = sorted(p)[len(p) // 2]
    edited = dict(p, **{name: p[name].clone()})
    edited[name].view(-1)[5] += 1
    assert tllm._model_fingerprint(edited) != fp
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    assert tllm._model_fingerprint(
        {k: v.to(other) for k, v in p.items()}) != fp
    assert torch.equal(edited[name].view(-1)[:5], p[name].view(-1)[:5])
