#!/usr/bin/env python3
"""Sharded training across cards, one card per rank (NCCL).

    python3 benchmarks/torch_train_cards.py [--steps 5] [--warm 2]

GPT-2 small (``CONFIGS["small"]``: bf16 compute, f32 master weights, the
reference's draw for seed 0, ``remat="dots"``) trains on one random
batch at bench.py's shape (global B=32, S=1024) through
``make_train_step`` over four ranks of a ``RankPool``, one card each:
``{fsdp: 4}``, ``{dp: 2, tp: 2}`` and ``{tp: 4}`` with the flash kernels,
``{dp: 2, sp: 2}`` with ring attention and ``{sp: 4}`` with Ulysses
attention; and on one card (``cuda:0``, the same step without a mesh)
first. For each: the losses of every step against one card's (the
first within ``FIRST_LOSS_TOL``, every one finite, the last below the
first), tok/s, step ms, MFU (bench.py's FLOPs a token, ``6 N + 12 L S
d``, over 989 TFLOP/s a card), peak memory per card, K2/K3 launches per rank, the
collectives a step by group, and each collective's ms at the step's
sizes (timed apart from the step, every rank taking part: the parameter
all-gathers, the gradient reduce-scatters and all-reduces, one tp
all-reduce of the ``[B/(dp*fsdp), S, d]`` f32 partials, one ring
exchange of a K/V chunk, one Ulysses all-to-all). Needs four cards;
prints every card's name and power limit, one JSON line per mesh, and
ends with ``{"ok": true, ...}``.
"""
import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

B, S = 32, 1024                     # bench.py's shape (bench.py:30-84)
PEAK = 989e12                       # H100 SXM dense bf16, one card
MESHES = [({"fsdp": 4}, "flash"), ({"dp": 2, "tp": 2}, "flash"),
          ({"tp": 4}, "flash"), ({"dp": 2, "sp": 2}, "ring"),
          ({"sp": 4}, "ulysses")]
#: One card's first loss against a mesh's: the same weights and batch,
#: bf16 products summed in another order (and ring/Ulysses attention's
#: plain einsums against the flash kernels), averaged over 32,768
#: tokens; cards run 1 saw 5e-5. Later steps are reported, not held:
#: AdamW turns each rounding difference into a whole lr step on the
#: weights whose gradients are near 0, and the losses drift apart (up to
#: 0.05 after 7 steps in cards run 1).
FIRST_LOSS_TOL = 1e-3


def _cfg(backend: str):
    from ray_tpu_torch.models import gpt

    return dataclasses.replace(gpt.CONFIGS["small"], remat="dots",
                               attn_backend=backend,
                               sp_axis="sp" if backend in (
                                   "ring", "ulysses") else None)


def _sync_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _steps(step, state, batch, warm: int, steps: int):
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    losses = []
    for _ in range(warm):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches.update(dict.fromkeys(fa.launches, 0))
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    return state, {"losses": losses,
                   "step_ms": (time.perf_counter() - t0) * 1e3 / steps,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "launches": dict(fa.launches)}


def _rank_bench(axes, backend, warm, steps):
    """One rank's run over ``axes``; returns its measurements."""
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import create_mesh

    cfg = _cfg(backend)
    mesh = create_mesh(axes)
    init, step, places, _ = gpt.make_train_step(cfg, mesh)
    state = init(seed=0)
    batch = cs._train_batch(cfg, B, S, 5, "cuda")
    before = {k: dict(g.stats) for k, g in mesh._groups.items()}
    state, out = _steps(step, state, batch, warm, steps)
    out["ops_per_step"] = {
        "/".join(k): {n: (v - before.get(k, {}).get(n, 0)) / (warm + steps)
                      for n, v in g.stats.items()}
        for k, g in mesh._groups.items()}
    local = state["params"]
    pl = places["params"]
    names = sorted(local)
    ms = {"gather_params": _sync_ms(
        lambda: [pl[n].gather(local[n]) for n in names], 3)}
    zeros = {n: torch.zeros(gpt.param_shapes(cfg)[n], device="cuda")
             for n in names}
    ms["reduce_grads"] = _sync_ms(
        lambda: [pl[n].reduce(zeros[n]) for n in names], 3)
    del zeros
    rows = B // mesh.size_of(("dp", "fsdp"))
    H, hd = cfg.n_head // mesh.shape.get("tp", 1), cfg.head_dim
    if mesh.shape.get("tp", 1) > 1:
        t = torch.zeros(rows, S, cfg.d_model, device="cuda")
        ms["tp_all_reduce"] = _sync_ms(
            lambda: mesh.group("tp").allreduce(t), 10)
    sp = mesh.shape.get("sp", 1)
    if backend == "ring" and sp > 1:
        kv = torch.zeros(rows, S // sp, H, 2 * hd, device="cuda",
                         dtype=cfg.dtype)
        ms["ring_permute"] = _sync_ms(
            lambda: mesh.group("sp").permute(kv, 1), 10)
    if backend == "ulysses" and sp > 1:
        x = torch.zeros(sp, rows, S // sp, H // sp, hd, device="cuda",
                        dtype=cfg.dtype)
        ms["ulysses_all_to_all"] = _sync_ms(
            lambda: mesh.group("sp").alltoall(x), 10)
    out["collective_ms"] = ms
    del state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warm", type=int, default=2)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from ray_tpu_torch._private.ranks import RankPool
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _build

    n = 4
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"needs {n} CUDA cards", file=sys.stderr)
        return 2
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    cs.log(f"cards: {cards}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    _build.build_all(["flash_attention"])    # before any rank starts

    cfg = _cfg("flash")
    flops_tok = 6 * cfg.num_params() + 12 * cfg.n_layer * S * cfg.d_model
    init, step, _, _ = gpt.make_train_step(cfg, device="cuda")
    state, one = _steps(step, init(seed=0),
                        cs._train_batch(cfg, B, S, 5, "cuda"), args.warm,
                        args.steps)
    del state, init, step
    torch.cuda.empty_cache()
    one.update(mesh="one card", tok_s=B * S / one["step_ms"] * 1e3)
    one["mfu"] = one["tok_s"] * flops_tok / PEAK
    cs.log(json.dumps(one))
    rows, bad = [one], []
    with RankPool(n) as pool:
        for axes, backend in MESHES:
            res = pool.run(_rank_bench, axes, backend, args.warm, args.steps)
            ms = max(r["step_ms"] for r in res)
            losses = res[0]["losses"]
            diff = max(abs(a - b) for a, b in zip(losses, one["losses"]))
            row = {"mesh": axes, "attn_backend": backend, "losses": losses,
                   "max_abs_diff_vs_one_card": diff, "step_ms": ms,
                   "tok_s": B * S / ms * 1e3,
                   "mfu": B * S / ms * 1e3 * flops_tok / (n * PEAK),
                   "peak_gib_per_card": [r["peak_gib"] for r in res],
                   "launches_per_rank": [r["launches"] for r in res],
                   "ops_per_step_rank0": res[0]["ops_per_step"],
                   "collective_ms_rank0": res[0]["collective_ms"]}
            cs.log(json.dumps(row))
            rows.append(row)
            first = abs(losses[0] - one["losses"][0])
            if not all(map(math.isfinite, losses)) or \
                    not losses[-1] < losses[0] or not first <= FIRST_LOSS_TOL:
                bad.append(f"{axes}: losses {losses} against one card's "
                           f"{one['losses']} (first within {FIRST_LOSS_TOL})")
    if bad:
        raise AssertionError("; ".join(bad))
    cs.log(json.dumps({"ok": True, "cards": cards, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
