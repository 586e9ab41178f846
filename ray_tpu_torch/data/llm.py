"""Offline batch inference: the port of ``ray_tpu/data/llm.py``, a
checkpointed stream of row blocks through one or more
:class:`~ray_tpu_torch.serve.engine.DecodeEngine` s ("run 10M prompts
overnight at full slot occupancy").

- **Streaming**: input blocks (any iterable of blocks, or an object with
  ``_exec_blocks()``) flow row by row into the engines
  (``engine.stream(...)``), and their token streams are collected
  concurrently. The driver holds only the in-flight window plus finished
  blocks waiting for their in-order yield.
- **Backpressure**: :class:`EngineSaturationPolicy` admits while an
  engine's admission backlog (``queue_depth()``) is below
  ``queue_factor * slots``: enough queued that a freed slot refills at
  the next chunk boundary, never so much that the queue absorbs the
  dataset.
- **Checkpointing**: with ``progress_path``, each finished block commits
  durably (:class:`ProgressLog`: one atomic directory rename; tokens
  through :class:`~ray_tpu_torch.train.checkpoint.Checkpoint`, retention
  through :class:`~ray_tpu_torch.train.checkpoint.CheckpointManager`)
  before it is yielded. A killed driver resumes **exactly once**:
  committed blocks come from the log with no row resubmitted, and the
  rest regenerate deterministically (a row's seed is ``seed`` plus its
  global row index, and a stream is a function of prompt, knobs and
  seed), so the resumed output is token-identical to an uninterrupted
  run at temperature 0 and seeded above it. The log's layout is the
  reference's: a block committed by either package loads in the other.
  Each committed block is also a ``data.block_commit`` event in the
  flight recorder (:mod:`~ray_tpu_torch._private.events`).
- **Faults in-run**: a retryable engine failure mid-stream (a driver
  death, a drain) resubmits the row with ``resume_from=<delivered>``
  after giving each engine's supervisor its chance to restart a dead
  driver, so one crashed engine costs a replay, not the run.

Exactly-once resume assumes the input re-executes deterministically:
the same blocks, the same row order.

The thread that iterates :meth:`BatchInferencer.run` is the pipeline
driver: it owns every submit, poll and commit, and no thread is spawned.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .._private.events import driver_emit as _driver_emit
from . import block as B


class BackpressurePolicy:
    """Decides when a stage may take another input (the port's copy of
    ``ray_tpu/data/executor.py:20-30``). The pipeline consults the policy
    before each submission and may report completions, so a policy can
    adapt to observed progress."""

    def can_add_input(self, num_in_flight: int) -> bool:
        raise NotImplementedError

    def on_task_finished(self, duration_s: float) -> None:
        pass


class EngineSaturationPolicy(BackpressurePolicy):
    """Admission throttle driven by the engines' live backlog.

    Batch inference bounds *engine backlog*, not task concurrency: enough
    queued requests that a freed slot refills at the very next chunk
    boundary (the pool stays saturated), but at most ``queue_factor *
    slots`` per engine, so a dataset of any size never piles into an
    unbounded admission queue. The signal is
    :meth:`DecodeEngine.queue_depth`.
    """

    def __init__(self, engines: Sequence, queue_factor: float = 2.0):
        engines = list(engines)
        if not engines:
            raise ValueError("EngineSaturationPolicy needs >= 1 engine")
        if queue_factor <= 0:
            raise ValueError(
                f"queue_factor must be > 0, got {queue_factor}")
        self.engines = engines
        self.queue_factor = float(queue_factor)

    def _limit(self, eng) -> int:
        return max(1, int(round(self.queue_factor * eng.slots)))

    def can_add_input(self, num_in_flight: int) -> bool:
        return any(e.queue_depth() < self._limit(e) for e in self.engines)

    def pick(self):
        """The least-backlogged engine with queue headroom, or None
        (every engine's backlog is at its bound: the caller waits for a
        chunk boundary to drain some)."""
        best, best_depth = None, None
        for e in self.engines:
            d = e.queue_depth()
            if d >= self._limit(e):
                continue
            if best is None or d < best_depth:
                best, best_depth = e, d
        return best


class ProgressLog:
    """Durable per-block completion log behind exactly-once resume.

    Layout under ``path`` (the reference's)::

        manifest.json          run fingerprint (the knobs that determine
                               output); a resume with other knobs raises
                               instead of mixing runs
        block_000007/          one committed block (an atomic rename from
            gen.npz            _staging): the generated tokens per row via
            meta.json          Checkpoint.from_state, and the output rows
            rows.npy           (without tokens) as a pickled object array,
                               so python and numpy types round-trip
                               exactly
        _staging/              payloads being written; wiped on open

    A block directory exists completely (the rename is atomic on one
    filesystem) or not at all, so a SIGKILL at any instant leaves the log
    consistent. Committed directories are registered with a
    :class:`~ray_tpu_torch.train.checkpoint.CheckpointManager` on open.
    """

    _BLOCK_RE = re.compile(r"^block_(\d+)$")

    def __init__(self, path: str, fingerprint: Optional[dict] = None):
        from ..train.checkpoint import Checkpoint, CheckpointManager

        self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)
        self._staging = os.path.join(self.path, "_staging")
        shutil.rmtree(self._staging, ignore_errors=True)
        os.makedirs(self._staging, exist_ok=True)
        fp = _canonical_fingerprint(fingerprint or {})
        man = os.path.join(self.path, "manifest.json")
        if os.path.exists(man):
            with open(man) as f:
                prev = json.load(f).get("fingerprint")
            if prev != fp:
                raise ValueError(
                    f"progress log {self.path} was written by a run with "
                    f"different generation knobs ({prev} != {fp}); "
                    f"resuming would mix token streams from two "
                    f"configurations — use a fresh progress_path or "
                    f"delete the old log")
        else:
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump({"fingerprint": fp}, f)
            os.replace(tmp, man)
        self._ckpt_cls = Checkpoint
        self._mgr = CheckpointManager(storage_dir=self.path)
        self._blocks: Dict[int, str] = {}
        for name in sorted(os.listdir(self.path)):
            m = self._BLOCK_RE.match(name)
            if not m:
                continue
            d = os.path.join(self.path, name)
            if not os.path.exists(os.path.join(d, "rows.npy")):
                # A torn directory (a partly deleted log, a dead writer's
                # leftovers): never half-trust it, and never let it block
                # this run's own commit rename later.
                shutil.rmtree(d, ignore_errors=True)
                continue
            idx = int(m.group(1))
            self._blocks[idx] = d
            self._mgr.register(Checkpoint(d), {"block": idx})

    @staticmethod
    def scan(path: str) -> set:
        """Committed block indices under ``path`` without opening the log
        (no manifest check): a watching process polls this while the
        driver runs."""
        out = set()
        try:
            names = os.listdir(path)
        except OSError:
            return out
        for name in names:
            m = ProgressLog._BLOCK_RE.match(name)
            if m and os.path.exists(os.path.join(path, name, "rows.npy")):
                out.add(int(m.group(1)))
        return out

    def committed(self) -> set:
        return set(self._blocks)

    def commit(self, idx: int, out_rows: List[Any],
               gen: List[np.ndarray]) -> str:
        """Durably record block ``idx``: the token arrays through the
        Checkpoint npz payload, the rows (without the token column) as a
        pickled object array, then ONE atomic rename into place.
        ``rows.npy`` is written last inside staging, so its presence in a
        renamed directory marks a complete commit."""
        ck = self._ckpt_cls.from_state(
            [np.asarray(g, np.int32) for g in gen],
            base_dir=self._staging, name="gen")
        arr = np.empty((len(out_rows),), dtype=object)
        for i, r in enumerate(out_rows):
            arr[i] = r
        np.save(os.path.join(ck.path, "rows.npy"), arr,
                allow_pickle=True)
        final = os.path.join(self.path, f"block_{idx:06d}")
        if os.path.exists(final):
            # A complete directory means another writer already made this
            # block durable (its content is deterministic: keep it);
            # anything else is garbage os.replace would trip over.
            if os.path.exists(os.path.join(final, "rows.npy")):
                shutil.rmtree(ck.path, ignore_errors=True)
                self._blocks[idx] = final
                return final
            shutil.rmtree(final)
        os.replace(ck.path, final)
        self._blocks[idx] = final
        self._mgr.register(self._ckpt_cls(final), {"block": idx})
        return final

    def load(self, idx: int, output_col: str) -> B.Block:
        """The committed output block ``idx``."""
        d = self._blocks[idx]
        gen = self._ckpt_cls(d).load_state(name="gen")
        rows = np.load(os.path.join(d, "rows.npy"),
                       allow_pickle=True).tolist()
        out = []
        for r, g in zip(rows, gen):
            row = dict(r)
            row[output_col] = np.asarray(g, np.int32)
            out.append(row)
        return B.rows_to_block(out)


def _canonical_fingerprint(d: dict) -> str:
    return json.dumps(d, sort_keys=True, default=str)


def _model_fingerprint(params: Dict[str, torch.Tensor]) -> str:
    """Cheap stable digest of the weights: every leaf's name, shape,
    dtype and first 128 elements (a few hundred bytes of device-to-host
    traffic a leaf, never the whole tensor), over the port's flat
    parameter dict in sorted-name order. A bf16 sample is hashed as its
    bits (numpy has no bf16), so the digest is the same on every device.
    Catches resuming a progress log against other weights, which would
    mix two models' token streams."""
    h = hashlib.sha1()
    for name in sorted(params):
        leaf = params[name].detach()
        for part in (name, tuple(leaf.shape), leaf.dtype):
            h.update(str(part).encode())
        sample = leaf.reshape(-1)[:128].cpu()
        if sample.dtype == torch.bfloat16:
            sample = sample.view(torch.int16)
        h.update(sample.numpy().tobytes())
    return h.hexdigest()


def _engine_generation_signature(eng) -> dict:
    """The engine state that determines a stream's tokens for a given
    (prompt, max_new, seed): what a pool must agree on and what the
    progress-log manifest fingerprints. The weights (sampled digest) and
    the sampling knobs; speculative decoding is exact at temperature 0
    but consumes each slot's PRNG on another schedule above it, so its
    knobs count too."""
    drafter = getattr(eng, "_drafter", None)
    return {
        "model": _model_fingerprint(getattr(eng, "params", {})),
        "temperature": getattr(eng, "temperature", 0.0),
        "eos_token": getattr(eng, "eos_token", -1),
        "spec_decode": getattr(drafter, "name", None)
        if drafter is not None else None,
        "draft_k": getattr(eng, "draft_k", None)
        if drafter is not None else None,
        "spec_threshold": getattr(eng, "spec_threshold", 0.0)
        if drafter is not None else None,
    }


@dataclass
class _Flight:
    """One in-flight row: its engine stream plus what it takes to replay
    it on another engine after a retryable failure."""

    block_idx: int
    row_pos: int
    prompt: np.ndarray
    max_new: int
    seed: int
    stream: Any = None            # _EngineStream
    engine: Any = None
    delivered: List[np.ndarray] = field(default_factory=list)
    n_tok: int = 0                # tokens delivered (the replay count)
    retries: int = 0


@dataclass
class _BlockState:
    """A partly generated input block: rows submitted in order, outputs
    landing out of order, committed when the last row finishes."""

    rows: List[Any]
    outs: List[Optional[np.ndarray]]
    done: int = 0


class BatchInferencer:
    """Stream row blocks through DecodeEngines at full occupancy.

    Usage::

        eng = DecodeEngine(params, cfg, slots=16, chunk=8, max_len=1024)
        bi = BatchInferencer(eng, prompts_col="prompt", max_new=64,
                             progress_path="ckpt/run1")
        for out_block in bi.run(blocks):
            ...   # rows carry an extra ``generated`` token column

    (or :func:`generate`, which builds and owns the engines).

    The thread iterating :meth:`run` is the pipeline driver: it owns
    every submit, poll and commit. Leaving the iterator (exhaustion, an
    exception, or ``close()``) closes every in-flight engine stream, so
    the engines free their slots and pages at the next chunk boundary and
    stay admissible for the next run.
    """

    def __init__(self, engines, *, prompts_col: str = "prompt",
                 output_col: str = "generated", max_new: int = 32,
                 max_new_col: Optional[str] = None, seed: int = 0,
                 queue_factor: float = 2.0,
                 policy: Optional[EngineSaturationPolicy] = None,
                 progress_path: Optional[str] = None,
                 fingerprint_extra: Optional[dict] = None,
                 max_retries: int = 4):
        if not isinstance(engines, (list, tuple)):
            engines = [engines]
        if not engines:
            raise ValueError("BatchInferencer needs >= 1 engine")
        self.engines = list(engines)
        # Rows go to whichever engine is least backlogged, so every
        # generation-determining knob must agree across the pool, or the
        # output would depend on load timing. The signature samples the
        # weights (device-to-host traffic a leaf): computed only for a
        # pool or a progress-log manifest.
        sig0 = None
        if len(self.engines) > 1 or progress_path:
            sig0 = _engine_generation_signature(self.engines[0])
        cap0 = (self.engines[0].prompt_buckets[-1],
                self.engines[0].max_len)
        for e in self.engines[1:]:
            sig = _engine_generation_signature(e)
            if sig != sig0:
                raise ValueError(
                    f"engines disagree on generation-determining knobs "
                    f"({sig0} != {sig}); batch inference routes rows by "
                    f"load, so every engine must produce identical "
                    f"streams for the same (prompt, seed)")
            cap = (e.prompt_buckets[-1], e.max_len)
            if cap != cap0:
                # Capacity does not change tokens, but a row that fits one
                # engine and not another would succeed or abort the run
                # depending on timing.
                raise ValueError(
                    f"engines disagree on admission capacity (max "
                    f"prompt bucket, max_len): {cap0} != {cap}; every "
                    f"engine must admit every row")
        self.prompts_col = prompts_col
        self.output_col = output_col
        self.max_new = int(max_new)
        self.max_new_col = max_new_col
        self.seed = int(seed)
        self.max_retries = int(max_retries)
        self.policy = policy or EngineSaturationPolicy(
            self.engines, queue_factor)
        self._log: Optional[ProgressLog] = None
        if progress_path:
            fp = {"prompts_col": prompts_col, "output_col": output_col,
                  "max_new": self.max_new, "max_new_col": max_new_col,
                  "seed": self.seed}
            fp.update(sig0)
            if fingerprint_extra:
                fp.update(fingerprint_extra)
            self._log = ProgressLog(progress_path, fp)
        self._flights: Dict[int, _Flight] = {}
        self._uid = 0
        self.stats: Dict[str, Any] = {
            "rows": 0, "rows_resumed_from_log": 0, "blocks": 0,
            "blocks_from_log": 0, "tokens": 0, "retries": 0,
            "stream_resumes": 0, "wall_s": 0.0}

    # ------------------------------------------------------------ plumbing
    def _row_prompt(self, row) -> np.ndarray:
        val = row[self.prompts_col] if isinstance(row, dict) else row
        return np.asarray(val, np.int32).reshape(-1)

    def _row_max_new(self, row) -> int:
        if self.max_new_col and isinstance(row, dict) \
                and self.max_new_col in row:
            return int(row[self.max_new_col])
        return self.max_new

    def _out_row(self, row, tokens: np.ndarray) -> dict:
        out = dict(row) if isinstance(row, dict) \
            else {self.prompts_col: row}
        out[self.output_col] = np.asarray(tokens, np.int32)
        return out

    def _submit(self, fl: _Flight, engine=None):
        """Hand one row (or its replay) to an engine. ``resume_from``
        carries the delivered-token count, so a retried row continues
        token-identically instead of re-streaming its prefix."""
        eng = engine or self.policy.pick() or min(
            self.engines, key=lambda e: e.queue_depth())
        fl.engine = eng
        fl.stream = eng.stream(fl.prompt, fl.max_new, seed=fl.seed,
                               resume_from=fl.n_tok)

    def _retry(self, fl: _Flight, exc: BaseException):
        """Replay a retryably failed row: give each engine's supervisor
        its chance to restart a dead driver, then resubmit with
        ``resume_from``, on the least-backlogged engine first. A row that
        exhausts its budget re-raises the triggering error, chained to
        the last resubmission failure."""
        last_err: Optional[BaseException] = None
        while fl.retries < self.max_retries:
            fl.retries += 1
            self.stats["retries"] += 1
            errs = []
            for eng in sorted(self.engines,
                              key=lambda e: e.queue_depth()):
                # Offline runs have no replica health pass, so the
                # pipeline driver doubles as the engine supervisor.
                try:
                    eng.supervise()
                except Exception:  # noqa: BLE001 - supervisor failed;
                    pass           # the engine stays down, try the next
                try:
                    self._submit(fl, engine=eng)
                    if fl.n_tok:
                        self.stats["stream_resumes"] += 1
                    return
                except Exception as e:  # noqa: BLE001 - try next engine
                    errs.append(e)
            if errs:
                last_err = errs[-1]
            if not any(getattr(e, "retryable", False) for e in errs):
                break
            time.sleep(0.05)
        raise exc from last_err

    def _drain_flight(self, uid: int, fl: _Flight,
                      pending: Dict[int, _BlockState]) -> bool:
        """Non-blocking pull of everything this flight's lane holds. True
        if the row completed (and was folded into its block)."""
        while True:
            try:
                evt = fl.stream.poll()
            except Exception as val:  # noqa: BLE001 - classified below
                if getattr(val, "retryable", False) \
                        and fl.retries < self.max_retries:
                    self._retry(fl, val)
                    # The flight now reads from a fresh lane; what the
                    # dead lane held was pulled above (errors trail
                    # items), so hand control back to the loop.
                    return False
                raise
            if evt is None:
                return False
            kind, val = evt
            if kind == "item":
                fl.delivered.append(np.asarray(val, np.int32))
                fl.n_tok += len(val)
                continue
            # kind == "end"
            toks = (np.concatenate(fl.delivered)
                    if fl.delivered else np.zeros((0,), np.int32))
            bs = pending[fl.block_idx]
            bs.outs[fl.row_pos] = toks
            bs.done += 1
            self.stats["rows"] += 1
            self.stats["tokens"] += int(toks.shape[0])
            del self._flights[uid]
            return True

    def _commit_block(self, idx: int, bs: _BlockState) -> B.Block:
        out_rows = [self._out_row(r, t) for r, t in zip(bs.rows, bs.outs)]
        if self._log is not None:
            skeletons = []
            for r in out_rows:
                sk = dict(r)
                sk.pop(self.output_col, None)
                skeletons.append(sk)
            self._log.commit(idx, skeletons, list(bs.outs))
        self.stats["blocks"] += 1
        _driver_emit("data.block_commit", block=idx, rows=len(out_rows),
                     tokens=sum(int(t.shape[0]) for t in bs.outs),
                     journaled=self._log is not None)
        return B.rows_to_block(out_rows)

    # -------------------------------------------------------------- driving
    def run(self, source) -> Iterator[B.Block]:
        """Generate for every row of ``source`` (an iterable of blocks,
        or anything with ``_exec_blocks()``); yields output blocks in
        input order. The consuming thread is the pipeline driver."""
        blocks = source._exec_blocks() if hasattr(source, "_exec_blocks") \
            else iter(source)
        try:
            yield from self._drive(blocks)
        finally:
            self.close()

    def _drive(self, blocks: Iterator[B.Block]) -> Iterator[B.Block]:
        t0 = time.time()
        committed = self._log.committed() if self._log else set()
        pending: Dict[int, _BlockState] = {}
        ready: Dict[int, B.Block] = {}
        next_emit = 0
        row_counter = 0           # global row index -> per-row seed
        cur: Optional[tuple] = None   # (idx, rows, pos)
        block_iter = enumerate(blocks)
        exhausted = False
        while True:
            progressed = False
            # 1. Admission: feed rows while the policy sees headroom.
            while not exhausted and self.policy.can_add_input(
                    len(self._flights)):
                if cur is None:
                    try:
                        idx, blk = next(block_iter)
                    except StopIteration:
                        exhausted = True
                        break
                    if idx in committed:
                        # Exactly once: the log holds this block, so no
                        # row is resubmitted; the seed cursor still
                        # advances past its rows. Break to emission so a
                        # long committed run streams out instead of
                        # piling up in driver memory.
                        n = B.block_len(blk)
                        loaded = self._log.load(idx, self.output_col)
                        if B.block_len(loaded) != n:
                            # The manifest pins generation knobs, but the
                            # block shape comes from the input: a resume
                            # under another blocking would duplicate or
                            # drop rows.
                            raise ValueError(
                                f"progress log block {idx} holds "
                                f"{B.block_len(loaded)} rows but the "
                                f"input now yields {n}; the input must "
                                f"re-execute with the SAME blocking for "
                                f"exactly-once resume — use a fresh "
                                f"progress_path for a changed input")
                        row_counter += n
                        ready[idx] = loaded
                        self.stats["blocks_from_log"] += 1
                        self.stats["rows_resumed_from_log"] += n
                        progressed = True
                        break
                    rows = list(B.iter_rows(blk))
                    if not rows:
                        ready[idx] = blk     # an empty block passes through
                        progressed = True
                        continue
                    pending[idx] = _BlockState(
                        rows=rows, outs=[None] * len(rows))
                    cur = (idx, rows, 0)
                idx, rows, pos = cur
                fl = _Flight(
                    block_idx=idx, row_pos=pos,
                    prompt=self._row_prompt(rows[pos]),
                    max_new=self._row_max_new(rows[pos]),
                    seed=self.seed + row_counter)
                row_counter += 1
                try:
                    self._submit(fl)
                except Exception as e:
                    # A just-crashed (draining) engine refuses fresh
                    # admissions retryably: take the same supervise and
                    # replay path as a mid-stream error.
                    if not getattr(e, "retryable", False):
                        raise
                    self._retry(fl, e)
                self._flights[self._uid] = fl
                self._uid += 1
                progressed = True
                pos += 1
                cur = (idx, rows, pos) if pos < len(rows) else None
            # 2. Collection: drain every flight's lane without blocking.
            for uid in list(self._flights):
                fl = self._flights[uid]
                if self._drain_flight(uid, fl, pending):
                    bs = pending[fl.block_idx]
                    if bs.done == len(bs.rows):
                        ready[fl.block_idx] = self._commit_block(
                            fl.block_idx, pending.pop(fl.block_idx))
                    progressed = True
            # 3. Emission: committed blocks leave in input order.
            while next_emit in ready:
                blk = ready.pop(next_emit)
                next_emit += 1
                self.stats["wall_s"] = time.time() - t0
                yield blk
                progressed = True
            if exhausted and not self._flights and not pending \
                    and not ready:
                break
            if not progressed:
                # Every lane is mid-chunk on the device: wait a beat
                # instead of spinning on empty queues.
                time.sleep(0.001)
        self.stats["wall_s"] = time.time() - t0

    def close(self):
        """Close every in-flight engine stream (abandonment): the engines
        free the slots and pages at their next chunk boundary and stay
        admissible. Idempotent; called when :meth:`run`'s generator exits
        for any reason."""
        for fl in self._flights.values():
            if fl.stream is not None:
                fl.stream.close()
        self._flights.clear()

    def engine_stats(self) -> List[dict]:
        return [e.stats() for e in self.engines]


def resolve_engines(model, num_engines: int = 1, **engine_knobs):
    """Normalize a ``model`` argument to a list of engines plus an
    ownership flag (owned engines are the caller's to shut down):

    - a ``DecodeEngine`` (or a list of them): used as it is, not owned;
    - a ``(params, cfg)`` tuple: ``num_engines`` fresh engines built with
      ``engine_knobs`` (on the card unless ``device=`` is among them),
      with distinct ``deployment`` labels when there are several; owned.
    """
    from ..serve.engine import DecodeEngine

    live = None
    if isinstance(model, DecodeEngine):
        live = [model]
    elif isinstance(model, (list, tuple)) \
            and model and all(isinstance(m, DecodeEngine) for m in model):
        live = list(model)
    if live is not None:
        if engine_knobs or num_engines != 1:
            # Ignoring the knobs would run the job with the engines'
            # existing configuration and nothing to flag it.
            raise ValueError(
                f"engine_knobs {sorted(engine_knobs)} / num_engines="
                f"{num_engines} only apply when engines are built from "
                f"a (params, cfg) model; configure live engines at "
                f"construction instead")
        return live, False
    if isinstance(model, (list, tuple)) and len(model) == 2:
        params, cfg = model
        base = engine_knobs.pop("deployment", "batch_gen")
        n = max(1, int(num_engines))
        engines = []
        try:
            for i in range(n):
                engines.append(DecodeEngine(
                    params, cfg,
                    deployment=base if n == 1 else f"{base}_{i}",
                    **engine_knobs))
        except BaseException:
            for eng in engines:
                eng.shutdown()
            raise
        return engines, True
    raise TypeError(
        "model must be a DecodeEngine, a list of DecodeEngines, or a "
        f"(params, cfg) tuple; got {type(model)}")


def generate(source, model, prompts_col: str = "prompt", *,
             output_col: str = "generated", max_new: int = 32,
             max_new_col: Optional[str] = None, seed: int = 0,
             num_engines: int = 1, queue_factor: float = 2.0,
             progress_path: Optional[str] = None,
             fingerprint_extra: Optional[Dict[str, Any]] = None,
             max_retries: int = 4, **engine_knobs) -> Iterator[B.Block]:
    """Offline batch inference over ``source`` (an iterable of blocks, or
    anything with ``_exec_blocks()``): every row gains an ``output_col``
    token column; output blocks come in input order. The body of the
    reference's ``Dataset.generate`` (``ray_tpu/data/dataset.py:88``).
    ``model`` is a ``DecodeEngine``, a list of them, or a ``(params,
    cfg)`` tuple (then ``num_engines`` engines are built from
    ``engine_knobs`` when iteration starts and shut down when the
    iterator closes, for any reason). With ``progress_path``, finished
    blocks commit durably and a killed run resumes exactly once — see
    :class:`BatchInferencer`."""
    engines, owned = resolve_engines(model, num_engines=num_engines,
                                     **engine_knobs)
    try:
        bi = BatchInferencer(
            engines, prompts_col=prompts_col, output_col=output_col,
            max_new=max_new, max_new_col=max_new_col, seed=seed,
            queue_factor=queue_factor, progress_path=progress_path,
            fingerprint_extra=fingerprint_extra, max_retries=max_retries)
        yield from bi.run(source)
    finally:
        if owned:
            for eng in engines:
                eng.shutdown()
