"""The port stands alone: ``ray_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor ``ml_dtypes`` nor anything of the JAX package
``ray_tpu``.

Checked twice: by an AST scan of every file in the package (the threefry
PRNG and the drafters, which reimplement JAX's and copy the reference's,
included) and of ``chip_smoke.py``, and by serving nano requests
(greedy, seeded temperature > 0, and speculative with the n-gram
drafter), handing one request off from a prefill engine to a decode
engine, taking a nano train step (flash attention, ``dots`` remat), and
serving one request and taking one train step with a nano
Mixture-of-Experts model, and serving one request on a tp=2 engine, in
a fresh interpreter where ``jax`` and ``ml_dtypes`` are poisoned in
``sys.modules`` and an import hook refuses them and ``ray_tpu`` and
``ray_tpu.*`` (but not ``ray_tpu_torch``). A subprocess, because this
suite's conftest imports JAX into the test process. The tp=2 engine's
follower process is spawned afresh, without that block, so it reports
the modules it imported over the group, after serving, and none of
them may be ``jax``, ``ml_dtypes`` or ``ray_tpu``.
"""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ray_tpu_torch")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "ray_tpu")


def test_no_jax_or_reference_imports_in_source():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    assert len(files) >= 10
    for must in ("_private/prng.py", "_private/tp.py", "serve/draft.py",
                 "serve/handoff.py"):
        assert os.path.join(PKG, must) in files, must
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    bad = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad


_CHILD = r"""
import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "ml_dtypes", "ray_tpu")
sys.modules["jax"] = None          # `import jax` raises ImportError
sys.modules["ml_dtypes"] = None


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, _Refuse())

import dataclasses

import numpy as np
import torch

from ray_tpu_torch.models import gpt
from ray_tpu_torch.serve._stream import _EngineStream
from ray_tpu_torch.serve.engine import DecodeEngine

cfg = gpt.CONFIGS["nano"]
params = gpt.init_params(cfg, seed=0, device="cpu")
eng = DecodeEngine(params, cfg, slots=2, chunk=4, max_len=64,
                   prompt_buckets=(8, 16), page_size=8, device="cpu")
try:
    outs = [np.concatenate(list(eng.stream(
        np.arange(n, dtype=np.int32) % cfg.vocab_size, 6)))
        for n in (5, 11)]
finally:
    eng.shutdown()
assert [o.shape for o in outs] == [(6,), (6,)], outs
for kw in (dict(temperature=0.8), dict(spec_decode="ngram", paged=False)):
    eng = DecodeEngine(params, cfg, slots=2, chunk=4, max_len=64,
                       prompt_buckets=(8, 16), device="cpu", **kw)
    try:
        out = np.concatenate(list(eng.stream(
            np.arange(7, dtype=np.int32), 9, seed=3)))
    finally:
        eng.shutdown()
    assert out.shape == (9,) and (out < cfg.vocab_size).all(), (kw, out)
# One handoff: a bf16 prefill engine exports, a decode engine imports.
bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
pre = DecodeEngine(params, bcfg, slots=2, chunk=4, max_len=64,
                   prompt_buckets=(8, 16), page_size=8, role="prefill",
                   device="cpu")
dec = DecodeEngine(params, bcfg, slots=2, chunk=4, max_len=64,
                   prompt_buckets=(8, 16), paged=False, role="decode",
                   device="cpu")
try:
    desc = pre.handoff(np.arange(7, dtype=np.int32), 6, seed=1)
    assert desc["payload"]["k"].dtype == np.uint16
    out = np.concatenate(list(_EngineStream(dec.admit_prefilled(desc))))
    ho = dec.stats()["handoff"]
finally:
    pre.shutdown()
    dec.shutdown()
assert out.shape == (6,) and ho["imported"] == 1, (out, ho)
assert ho["import_fallbacks"] == 0, ho
tcfg = dataclasses.replace(cfg, attn_backend="flash", remat="dots")
init, step = gpt.make_train_step(tcfg, device="cpu")
state, metrics = step(init(seed=0), {"tokens": np.arange(
    2 * 17, dtype=np.int64).reshape(2, 17) % cfg.vocab_size})
assert state["step"] == 1 and bool(torch.isfinite(metrics["loss"]))
# Mixture-of-Experts: one served request and one train step.
mcfg = dataclasses.replace(cfg, n_experts=4)
mparams = gpt.init_params(mcfg, seed=0, device="cpu")
eng = DecodeEngine(mparams, mcfg, slots=2, chunk=4, max_len=64,
                   prompt_buckets=(8, 16), page_size=8, device="cpu")
try:
    out = np.concatenate(list(eng.stream(np.arange(7, dtype=np.int32), 6)))
finally:
    eng.shutdown()
assert out.shape == (6,), out
init, step = gpt.make_train_step(dataclasses.replace(tcfg, n_experts=4),
                                 device="cpu")
state, metrics = step(init(seed=0), {"tokens": np.arange(
    2 * 17, dtype=np.int64).reshape(2, 17) % cfg.vocab_size})
assert float(metrics["moe_aux"]) > 0, metrics
# Tensor parallelism: a tp=2 engine; its follower reports its modules.
from ray_tpu_torch._private import tp

eng = DecodeEngine(params, cfg, slots=2, chunk=4, max_len=64,
                   prompt_buckets=(8, 16), page_size=8, tp=2, device="cpu")
try:
    out = np.concatenate(list(eng.stream(np.arange(7, dtype=np.int32), 6)))
finally:
    eng.shutdown()
assert out.shape == (6,), out
report, = tp.decode_group(2).probe()
assert "torch" in report["modules"], report
follower = sorted(set(report["modules"]) & set(BLOCKED))
assert not follower, follower
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ISOLATED-OK")
"""


def test_serves_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "ISOLATED-OK" in res.stdout
