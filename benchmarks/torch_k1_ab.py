#!/usr/bin/env python3
"""A/B of K1, the port's paged decode-attention kernel, against an
earlier version of it, in one process on one NVIDIA card.

    git show <commit>:ray_tpu_torch/ops/paged_attention.py > build/k1_old/paged_attention.py
    git show <commit>:ray_tpu_torch/ops/csrc/paged_attention.cu > build/k1_old/paged_attention.cu
    python3 benchmarks/torch_k1_ab.py --old-dir build/k1_old

(``build/`` is git-ignored.) The old wrapper module is loaded beside this
checkout's ``ray_tpu_torch.ops.paged_attention`` and its kernel source is
built with the same ``nvcc`` flags. Both are held against the plain
version, then timed in turns (old, new, new, old) at three decode shapes
with bf16 and int8 pools: GPT-2 small's serving step and the 1b skewed
step (``chip_smoke.K1_SHAPES``), and one slot of 6 positions, where the
device work is far shorter than the host's. Per version and turn:

- ``ms``: device time per call (``chip_smoke.device_ms``, the profiler);
- ``call_ms``: CUDA events around calls back to back (``chip_smoke.cuda_ms``);
- ``host_us``: the host's wall time per wrapper call, over calls back to
  back with no synchronisation (the best of three runs); where the
  device is the shorter, this is what a call costs the host;
- ``c_us``: the same for the bare C entry point called through ctypes
  with its arguments made once: the tensor maps, the launch and ctypes.

The card's name and power limit come first; then one JSON line per
shape and pool.
"""
import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SHAPES = {**cs.K1_SHAPES,
          "one_short": dict(H=12, hd=64, ps=16, max_pages=64, pos=[5])}


def load_old(old_dir: Path):
    """The wrapper module in ``old_dir`` with its kernel source built
    there: an earlier ``ray_tpu_torch.ops.paged_attention``."""
    import subprocess

    from ray_tpu_torch.ops import _build

    lib = old_dir.resolve() / "paged_attention_old.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                          f"-I{_build.CSRC}", "-o", str(lib),
                          str(old_dir / "paged_attention.cu")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the old source:\n{res.stdout}")
    spec = importlib.util.spec_from_file_location(
        "ray_tpu_torch.ops._paged_attention_old",
        old_dir / "paged_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = SimpleNamespace(build=lambda name: (lib, ""))
    return mod


def host_us(fn, iters: int = 1000, runs: int = 3) -> float:
    """Best of ``runs``: host wall time per call of ``fn(i)`` over
    ``iters`` calls back to back, the queue drained before each run."""
    import torch

    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        best = min(best, (time.perf_counter() - t0) / iters * 1e6)
    torch.cuda.synchronize()
    return best


def c_entry(mod, args):
    """A call of ``mod``'s C entry point for ``args``, its arguments made
    once by a call of its wrapper that records them, and the output that
    the call writes (keep it alive while calling)."""
    recorded = []
    lib = mod._load()
    real = lib.rt_paged_attention

    class Recorder:
        def __call__(self, *a):
            recorded.append(a)
            return real(*a)

    mod._lib = SimpleNamespace(rt_paged_attention=Recorder(),
                               **{k: getattr(lib, k) for k in dir(lib)
                                  if k.startswith("rt_") and
                                  k != "rt_paged_attention"})
    try:
        out = mod.paged_attention_cuda(*args)
    finally:
        mod._lib = lib
    a = recorded[0]
    return lambda i: real(*a), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-dir", required=True, type=Path,
                    help="holds an earlier paged_attention.py and .cu")
    ap.add_argument("--iters", type=int, default=240)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_ab: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import paged_attention as pa

    card = cs.card_line()
    print(card, flush=True)
    mods = {"old": load_old(a.old_dir), "new": pa}
    for shape, s in SHAPES.items():
        for kv in ("fp", "int8"):
            inp = cs.decode_inputs(s, kv)
            errs = {who: cs.max_err(m.paged_attention_cuda, inp)
                    for who, m in mods.items()}
            rec = {k: {"old": [], "new": []}
                   for k in ("ms", "call_ms", "host_us", "c_us")}
            for who in ("old", "new", "new", "old"):
                fn = mods[who].paged_attention_cuda
                call = lambda i: fn(*inp.args(i))  # noqa: E731
                rec["ms"][who].append(cs.device_ms(call, a.iters))
                rec["call_ms"][who].append(cs.cuda_ms(call, a.iters))
                rec["host_us"][who].append(host_us(call))
                bare, out = c_entry(mods[who], inp.args(0))
                rec["c_us"][who].append(host_us(bare))  # writes into out
                del out
            print(json.dumps({"shape": shape, "kv": kv, "card": card,
                              "B": inp.B, "max_abs_err": errs, **rec,
                              **cs.k1_work(inp)}), flush=True)
            del inp
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
