"""The port's DecodeEngine serving a Mixture-of-Experts model, on the CPU
at nano size (``n_experts=4, expert_top_k=2``) with an f32 compute dtype,
held against the reference ``ray_tpu.serve.engine.DecodeEngine``. Each
package draws its own weights from seed 0 (``init_params`` is bit-equal,
``tests/test_torch_init_params.py``), so nothing is passed across.

An MoE dispatch couples the rows of a batch: capacity is handed out
first come, first served over every row, inactive slots' rows included.
So the streams depend on which requests share the pool, in which slots,
and on what the inactive rows hold. Every engine here gets all its
requests before it starts (``auto_start=False``), so both packages admit
them in the same order at the same chunk boundaries. With a capacity
factor of 0.25 every expert holds 8 pairs, and a 12-slot pool overflows
it in decode while the slots of finished requests sit, inactive, before
active ones; :class:`Coupling` checks that inactive rows did keep pairs
in an expert that dropped an active row's. Every stream must be
token-identical to the reference's: paged fp and int8 pools, the flat
pool, n-gram and model-drafter speculation, and a prefill→decode
handoff, at temperature 0 and 0.8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.serve import draft as jdraft
from ray_tpu.serve.batching import _EngineStream as JaxStream
from ray_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import gpt_decode as tgd
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.serve.batching import _EngineStream
from ray_tpu_torch.serve.engine import DecodeEngine
from torch_threads import one_torch_thread  # noqa: F401

MOE = dict(n_experts=4, expert_top_k=2)
KW = dict(slots=12, chunk=4, max_len=64, prompt_buckets=(8, 16),
          page_size=8)
# 14 requests for 12 slots: the first four finish early and leave holes
# before the active slots; the last two wait for a free slot.
LENS = [5, 9, 3, 12, 7, 16, 4, 11, 6, 14, 8, 10, 13, 5]
MAX_NEWS = [3, 5, 2, 6, 20, 24, 18, 22, 19, 21, 23, 20, 17, 16]
SEEDS = [3, 0, 7, 2 ** 31 - 1, -3, 11, 5, 8, 9, 1, 2, 4, 6, 10]


def _cfgs(cf):
    return (dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32,
                                capacity_factor=cf, **MOE),
            dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32,
                                capacity_factor=cf, **MOE))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs(1.25)
    return (jgpt.init_params(jax.random.PRNGKey(0), jcfg),
            tgpt.init_params(tcfg, 0, device="cpu"))


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, (n,)).astype(np.int32) for n in LENS]


class Coupling:
    """Records every MoE dispatch the port's engine makes over a pool
    (decode steps and verify rounds, where each row belongs to a slot):
    how often an expert dropped an active row's pair while an inactive
    row kept one, and whether an inactive slot sat before an active one."""

    def __init__(self, monkeypatch):
        self.rows = None
        self.coupled = self.holes_first = self.dispatches = 0
        route, chunk, verify = tmoe.route, tgd._chunk_slots, tgd._verify

        def rec_route(probs, top_k, cap):
            r = route(probs, top_k, cap)
            if self.rows is not None and probs.shape[0] == len(self.rows):
                self._note(r, probs.shape[1])
            return r

        def rec_chunk(step, cache, token, rngs, active, **kw):
            return self._with(np.asarray(active, bool), chunk, step, cache,
                              token, rngs, active, **kw)

        def rec_verify(params, cache, token, draft, rngs, active, **kw):
            rows = np.repeat(np.asarray(active, bool), kw["k"] + 1)
            return self._with(rows, verify, params, cache, token, draft,
                              rngs, active, **kw)

        monkeypatch.setattr(tmoe, "route", rec_route)
        monkeypatch.setattr(tgd, "_chunk_slots", rec_chunk)
        monkeypatch.setattr(tgd, "_verify", rec_verify)

    def _with(self, rows, fn, *a, **kw):
        self.rows = rows
        try:
            return fn(*a, **kw)
        finally:
            self.rows = None

    def _note(self, r, E):
        act = self.rows
        self.dispatches += 1
        idle = np.flatnonzero(~act)
        if idle.size and idle[0] < np.flatnonzero(act).max(initial=-1):
            self.holes_first += 1
        keep, ex = r.keep.numpy(), r.expert.numpy()
        if any(((~keep) & (ex == e))[:, act].any()
               and (keep & (ex == e))[:, ~act].any() for e in range(E)):
            self.coupled += 1


def _run(eng, prompts, port, seeds, descs=None):
    """Queue every request (or import every handoff), then start."""
    if descs is not None:
        lanes = [eng.admit_prefilled(d) for d in descs]
    else:
        lanes = [eng.submit(p, m, seed=s)
                 for p, m, s in zip(prompts, MAX_NEWS, seeds)]
    eng.start()
    wrap = _EngineStream if port else JaxStream
    return [np.concatenate(list(wrap(lane))) for lane in lanes]


def _serve(params, cfg, port, temperature, path, prompts, seeds):
    kw = dict(KW, temperature=temperature)
    if path == "flat":
        kw["paged"] = False
    else:
        kw.update(paged=True, kv_dtype="int8" if path == "paged-int8"
                  else "fp")
    if path.startswith("spec"):
        kw.update(spec_decode=path.split("-")[1], draft_k=4)

    def engine(**extra):
        if port:
            if kw.get("paged"):
                extra.setdefault("attn_kernel", "gather")
            return DecodeEngine(params, cfg, device="cpu", **kw, **extra)
        return JaxEngine(params, cfg, **kw, **extra)

    descs = None
    if path == "handoff":
        pre = engine(role="prefill")
        try:
            descs = [pre.handoff(p, m, seed=s)
                     for p, m, s in zip(prompts, MAX_NEWS, seeds)]
        finally:
            pre.shutdown()
        eng = engine(role="decode", auto_start=False)
    else:
        eng = engine(auto_start=False)
    try:
        if not port and isinstance(eng._drafter, jdraft.ModelDrafter):
            # The reference drafter's cursor may alias its numpy buffer
            # on the CPU (tests/test_torch_spec.py::unaliased_pos).
            eng._drafter._pos = np.zeros(2 * eng._drafter.slots,
                                         np.int32)[::2]
        outs = _run(eng, prompts, port, seeds, descs)
        return outs, eng.stats()
    finally:
        eng.shutdown()


PATHS = ["paged-fp", "paged-int8", "flat", "spec-ngram", "spec-model",
         "handoff"]
CASES = [(p, t, 0.25) for p in PATHS for t in (0.0, 0.8)] + [
    ("paged-fp", 0.0, 1.25), ("spec-model", 0.8, 1.25)]


@pytest.mark.parametrize("path,temperature,cf", CASES)
def test_streams_match_reference(weights, monkeypatch, path, temperature,
                                 cf):
    """cf 0.25: experts overflow in prefill, decode and verify, inactive
    rows take capacity from active ones, and every stream is still the
    reference's. cf 1.25: no expert overflows (capacity 16 for 12-16
    rows), the plain MoE path."""
    jcfg, tcfg = _cfgs(cf)
    jp, tp = weights
    prompts = _prompts()
    seeds = SEEDS if temperature else [0] * len(LENS)
    want, _ = _serve(jp, jcfg, False, temperature, path, prompts, seeds)
    seen = Coupling(monkeypatch)
    got, st = _serve(tp, tcfg, True, temperature, path, prompts, seeds)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"stream {i}")
    assert [len(g) for g in got] == MAX_NEWS
    assert seen.dispatches > 0 and seen.holes_first > 0
    if cf < 1:
        assert seen.coupled > 0, "no inactive row took an active's place"
    if path.startswith("spec"):
        assert st["spec"]["rounds"] > 0
    if path == "handoff":
        assert st["handoff"]["imported"] == len(LENS)
        assert st["handoff"]["import_fallbacks"] == 0


def test_zero_router_drops_by_position(weights):
    """A zero router gives every expert equal probability: top-2 is
    experts 0 and 1 for every row (the lower indices, as ``lax.top_k``),
    so with 12 rows and 8 slots rows 8-11 of every decode step are dropped
    whatever they hold. The streams still equal the reference's."""
    jcfg, tcfg = _cfgs(0.25)
    jp, tp = weights
    jp = dict(jp, block=dict(jp["block"], router={
        "kernel": jnp.zeros_like(jp["block"]["router"]["kernel"])}))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    prompts = _prompts()
    seeds = [0] * len(LENS)
    want, _ = _serve(jp, jcfg, False, 0.0, "paged-fp", prompts, seeds)
    got, _ = _serve(tp, tcfg, True, 0.0, "paged-fp", prompts, seeds)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"stream {i}")
    r = tmoe.route(torch.full((12, 4), 0.25), 2, 8)
    assert r.expert[0].eq(0).all() and r.expert[1].eq(1).all()
    assert r.keep[:, :8].all() and not r.keep[:, 8:].any()


def test_engine_config_plane_accepts_moe(weights):
    """``apply_config`` (paging, speculation, role) and ``ensure_paging``
    take an MoE engine; ``tp`` stays 1: above it an MoE config is
    refused as the reference refuses it (``gpt_decode.py:228``)."""
    _, tcfg = _cfgs(1.25)
    eng = DecodeEngine(weights[1], tcfg, device="cpu", auto_start=False,
                       paged=False, **{k: v for k, v in KW.items()
                                       if k != "page_size"})
    try:
        eng.apply_config(page_size=8, attn_kernel="gather", kv_dtype="int8",
                         spec_decode="model", draft_k=2, role="decode",
                         tp=1)
        assert eng.paged and eng.kv_dtype == "int8"
        assert eng._drafter.cfg.n_experts == 4
        eng.ensure_paging(page_size=8, kv_dtype="fp")
        assert eng.kv_dtype == "fp"
        with pytest.raises(ValueError, match="MoE"):
            eng.ensure_tp(2)
        assert eng.tp == 1
    finally:
        eng.shutdown()
