#!/usr/bin/env python3
"""Pipeline and expert parallelism across cards, one card per rank (NCCL).

    python3 benchmarks/torch_pp_ep_cards.py [--steps 5] [--warm 2]
        [--meshes ep2-tp2 dp2-sp2 ...]

GPT-2 small (``CONFIGS["small"]``: bf16 compute, f32 master weights, the
reference's draw for seed 0, ``remat="dots"``, flash) trains on one
random batch at bench.py's shape (global B=32, S=1024) through
``make_train_step`` on one card (``cuda:0``, no mesh) first, then over
four ranks of a ``RankPool``, one card each: the pipeline on ``{pp:4}``
at 8 microbatches, ``{pp:2,tp:2}``, ``{dp:2,pp:2}`` and ``{pp:2,sp:2}``
(ring attention inside a stage), each at the default ``2 * pp``
microbatches otherwise; then GPT-2 small with 8 experts, top-2, on one
card, ``{ep:4}``, ``{dp:2,ep:2}``, ``{ep:2,tp:2}`` (each tp rank
``d_ff/2`` of every local expert) and ``{dp:2,sp:2}`` with ring
attention (each sp rank a sequence chunk of every row, routed in the
global token order). For each: the first step's loss
within ``FIRST_LOSS_TOL`` of one card's, every loss finite and the last
below the first, step ms, tok/s, MFU (FLOPs a step over 4 x 989
TFLOP/s: bench.py's ``6 N + 12 L S d`` a token for the dense model, the
MoE step's count written out as ``chip_smoke.train_phase`` does), peak
memory per card, K2/K3 launches per rank and the collectives a step by
group on rank 0. ``--meshes`` runs only the named meshes (axes and
sizes joined, e.g. ``pp2-tp2``) and the one-card runs they are held
to. Needs four cards; prints every card's name and power
limit, one JSON line per run, and ends with ``{"ok": true, ...}``.
"""
import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from torch_train_cards import B, PEAK, S, _steps  # noqa: E402

EXPERTS = 8
MESHES = [({"pp": 4}, {"pp_axis": "pp", "num_microbatches": 8}),
          ({"pp": 2, "tp": 2}, {"pp_axis": "pp"}),
          ({"dp": 2, "pp": 2}, {"pp_axis": "pp"}),
          ({"pp": 2, "sp": 2}, {"pp_axis": "pp", "sp_axis": "sp"}),
          ({"ep": 4}, {"n_experts": EXPERTS}),
          ({"dp": 2, "ep": 2}, {"n_experts": EXPERTS}),
          ({"ep": 2, "tp": 2}, {"n_experts": EXPERTS}),
          ({"dp": 2, "sp": 2}, {"n_experts": EXPERTS, "attn_backend": "ring",
                                "sp_axis": "sp"})]
#: One card's first loss against a mesh's: the same weights and batch,
#: bf16 products of other shapes (microbatches, row halves, tp partials
#: rounded to bf16 before their sum, as the reference does) averaged
#: over 32,768 tokens.
FIRST_LOSS_TOL = 5e-5


def _name(axes) -> str:
    return "-".join(f"{k}{v}" for k, v in axes.items())


def _cfg(kw):
    from ray_tpu_torch.models import gpt

    return dataclasses.replace(gpt.CONFIGS["small"], remat="dots",
                               **{"attn_backend": "flash", **kw})


def _flops_step(cfg) -> float:
    """Model FLOPs of one step on the global batch."""
    from ray_tpu_torch.models import moe

    L, d, f, T = cfg.n_layer, cfg.d_model, cfg.d_ff, B * S
    flops_tok = 6 * cfg.num_params() + 12 * L * S * d
    if not cfg.n_experts:
        return T * flops_tok
    E = cfg.n_experts
    C = moe.capacity(T, E, cfg.expert_top_k, cfg.capacity_factor)
    dense = flops_tok - 6 * L * 2 * d * f
    return T * (dense + 6 * L * d * E) + 6 * L * 2 * E * C * d * f


def _rank_bench(axes, kw, warm, steps):
    """One rank's run over ``axes``; returns its measurements."""
    import chip_smoke as cs
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import create_mesh

    import torch

    cfg = _cfg(kw)
    mesh = create_mesh(axes)
    init, step, _, _ = gpt.make_train_step(cfg, mesh)
    state = init(seed=0)
    batch = cs._train_batch(cfg, B, S, 5, "cuda")
    before = {k: dict(g.stats) for k, g in mesh._groups.items()}
    state, out = _steps(step, state, batch, warm, steps)
    out["ops_per_step"] = {
        "/".join(k): {n: (v - before.get(k, {}).get(n, 0)) / (warm + steps)
                      for n, v in g.stats.items()}
        for k, g in mesh._groups.items()}
    del state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--meshes", nargs="*", default=None,
                    choices=[_name(a) for a, _ in MESHES])
    args = ap.parse_args()
    meshes = [(a, kw) for a, kw in MESHES
              if args.meshes is None or _name(a) in args.meshes]

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

    one = {}
    for kw in ({}, {"n_experts": EXPERTS}):
        if not any(("n_experts" in m) == bool(kw) for _, m in meshes):
            continue
        cfg = _cfg(kw)
        init, step, _, _ = gpt.make_train_step(cfg, device="cuda")
        state, row = _steps(step, init(seed=0),
                            cs._train_batch(cfg, B, S, 5, "cuda"), args.warm,
                            args.steps)
        del state, init, step
        torch.cuda.empty_cache()
        row.update(mesh="one card", config=kw,
                   tok_s=B * S / row["step_ms"] * 1e3,
                   mfu=_flops_step(cfg) / (row["step_ms"] * 1e-3) / PEAK)
        cs.log(json.dumps(row))
        one[bool(kw)] = row
    rows, bad = list(one.values()), []
    with RankPool(n) as pool:
        for axes, kw in meshes:
            res = pool.run(_rank_bench, axes, kw, args.warm, args.steps)
            ms = max(r["step_ms"] for r in res)
            losses = res[0]["losses"]
            ref = one["n_experts" in kw]["losses"]
            first = abs(losses[0] - ref[0])
            row = {"mesh": axes, "config": kw, "losses": losses,
                   "first_loss_diff_vs_one_card": first, "step_ms": ms,
                   "tok_s": B * S / ms * 1e3,
                   "mfu": _flops_step(_cfg(kw)) / (ms * 1e-3) / (n * PEAK),
                   "peak_gib_per_card": [r["peak_gib"] for r in res],
                   "launches_per_rank": [r["launches"] for r in res],
                   "ops_per_step_rank0": res[0]["ops_per_step"]}
            cs.log(json.dumps(row))
            rows.append(row)
            if not all(map(math.isfinite, losses)) or \
                    not losses[-1] < losses[0] or not first <= FIRST_LOSS_TOL:
                bad.append(f"{axes} {kw}: losses {losses} against one "
                           f"card's {ref} (first within {FIRST_LOSS_TOL})")
    if bad:
        raise AssertionError("; ".join(bad))
    cs.log(json.dumps({"ok": True, "cards": cards, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
