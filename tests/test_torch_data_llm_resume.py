"""Exactly once under SIGKILL: a batch-inference driver of the port
(``ray_tpu_torch.data.llm``), running in a child process at nano size on
the CPU with its engine throttled, is killed once at least two blocks
have committed to its progress log; the run resumed in this process
from the same log loses no row, repeats none, serves the committed
blocks without admitting their rows, and gives the tokens of an
uninterrupted run, at temperature 0 and seeded 0.8.

The child driver is this file run as a script (``__main__`` below). It
refuses ``jax`` and ``ray_tpu`` at import, as the card's machine would,
so the module imports only numpy, torch and the port at its top.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.data import block as TB
from ray_tpu_torch.data import llm as tllm
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve.engine import DecodeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T32 = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
KW = dict(slots=2, chunk=4, max_len=64, prompt_buckets=(8, 16))
ROWS, BLOCK, MAX_NEW, SEED = 24, 4, 12, 7
N_BLOCKS = ROWS // BLOCK


def _blocks():
    rng = np.random.default_rng(11)
    rows = [{"rid": i, "prompt": rng.integers(
        0, T32.vocab_size, (int(rng.integers(5, 17)),)).astype(np.int32)}
        for i in range(ROWS)]
    return [TB.rows_to_block(rows[i:i + BLOCK])
            for i in range(0, ROWS, BLOCK)]


def _run(params, temperature, progress=None, throttle_s=0.0):
    """(rows, pipeline stats, engine stats) of one pipeline run."""
    eng = DecodeEngine(params, T32, temperature=temperature, device="cpu",
                       **KW)
    try:
        if throttle_s:
            eng.inject_fault("driver_slow", wedge_s=throttle_s)
        bi = tllm.BatchInferencer(eng, max_new=MAX_NEW, seed=SEED,
                                  progress_path=progress)
        rows = [r for b in bi.run(_blocks()) for r in TB.iter_rows(b)]
        return rows, bi.stats, eng.stats()
    finally:
        eng.shutdown()


def _kill_when_committed(proc, progress, k, timeout_s=60.0) -> bool:
    """SIGKILL ``proc`` as soon as ``k`` blocks have committed; False if it
    exited first or the time ran out."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and proc.poll() is None:
        if len(tllm.ProgressLog.scan(progress)) >= k:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            return True
        time.sleep(0.005)
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    return False


@pytest.fixture(scope="module")
def params():
    return tgpt.init_params(T32, 0, device="cpu")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_sigkill_resume_exactly_once(params, temperature, tmp_path):
    want, _, _ = _run(params, temperature)
    progress = str(tmp_path / "progress")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), progress,
         str(temperature)], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        killed = _kill_when_committed(proc, progress, 2)
        err = "" if killed else proc.stderr.read().decode()[-3000:]
    finally:
        proc.stderr.close()
    assert killed, err
    committed = tllm.ProgressLog.scan(progress)
    assert 2 <= len(committed) < N_BLOCKS, committed
    got, stats, est = _run(params, temperature, progress=progress)
    assert [r["rid"] for r in got] == list(range(ROWS))  # none lost or twice
    n_logged = BLOCK * len(committed)
    assert stats["blocks_from_log"] == len(committed)
    assert stats["rows_resumed_from_log"] == n_logged
    assert est["admitted"] == ROWS - n_logged      # committed: none admitted
    for a, b in zip(got, want):
        assert np.array_equal(a["prompt"], b["prompt"])
        assert np.array_equal(a["generated"], b["generated"]), a["rid"]
        assert a["generated"].dtype == np.int32


if __name__ == "__main__":
    import importlib.abc

    BLOCKED = ("jax", "jaxlib", "ray_tpu")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    if loaded:
        sys.exit(f"the child driver imported {loaded}")

    class _Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, _Refuse())
    _run(tgpt.init_params(T32, 0, device="cpu"), float(sys.argv[2]),
         progress=sys.argv[1], throttle_s=0.05)
    sys.exit(0)
