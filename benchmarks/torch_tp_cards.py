#!/usr/bin/env python3
"""Tensor-parallel decode across cards, one card per rank (NCCL).

    python3 benchmarks/torch_tp_cards.py [--tp 2 4]

GPT-2 small (``CONFIGS["small"]``, bf16, the reference's draw for seed
0) serves ``chip_smoke.serving_requests`` (12 requests, 16 slots, chunk
8, page 16, K1) through ``DecodeEngine(tp=N)``, rank 0 this process on
``cuda:0`` and ranks 1..N-1 follower processes on ``cuda:1..N-1``, and
through ``DecodeEngine(tp=1)`` on ``cuda:0``. For each width: K1's
launches on every rank (``n_layer * chunk`` a dispatch each), the bf16
streams against tp=1 with every parting held to a near-tie of the f32
logits (``chip_smoke.compare``), the f32 streams within
``MAX_DIVERGED["f32"]``; TTFT/TPOT p50, tok/s and the host ms of one f32
all-reduce of ``[16, 768]`` (completion included). Needs as many cards
as the largest width; prints every card's name and power limit, one
JSON line per width, and ends with ``{"ok": true, ...}``.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tp", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from ray_tpu_torch._private import tp
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import paged_attention as pa

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < max(args.tp):
        print(f"needs {max(args.tp)} CUDA cards", file=sys.stderr)
        return 2
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    cs.log(f"cards: {cards}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    # Build K1 here before any follower starts, so no two processes
    # race to build it.
    _build.build_all(["paged_attention"])

    cfg = gpt.CONFIGS["small"]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = gpt.init_params(cfg, seed=0, device="cuda",
                             dtype=torch.bfloat16)
    params32 = gpt.init_params(cfg32, seed=0, device="cuda")
    reqs = cs.serving_requests()
    reqs32 = [(p, 32) for p, _ in reqs]
    dev = torch.device("cuda")
    cs.serve(params, cfg, reqs[:2], device=dev, attn_kernel="cuda")  # warm
    one = cs.serve(params, cfg, reqs, device=dev, attn_kernel="cuda")
    one32 = cs.serve(params32, cfg32, reqs32, device=dev,
                     attn_kernel="cuda")[0]
    rows = [{"tp": 1, "ttft_p50_ms": cs.p50(one[1]) * 1e3,
             "tpot_p50_ms": cs.p50(one[2]) * 1e3,
             "tok_s": sum(map(len, one[0])) / one[3]}]
    cs.log(json.dumps(rows[0]))
    for n in args.tp:
        t0 = time.perf_counter()
        group = tp.decode_group(n, device=dev)
        try:
            start_s = time.perf_counter() - t0
            ar_ms = group.all_reduce_ms((16, cfg.d_model), 200)
            cs.serve(params, cfg, reqs[:2], device=dev, attn_kernel="cuda",
                     tp=n)                                     # warm
            pa.launches = 0
            group.probe(reset=True)
            toks, ttft, tpot, wall, stats = cs.serve(
                params, cfg, reqs, device=dev, attn_kernel="cuda", tp=n)
            launches = [pa.launches] + [r["k1_launches"]
                                        for r in group.probe()]
            want = cfg.n_layer * 8 * stats["dispatches"]
            if stats["completed"] != len(reqs) or \
                    launches != [want] * n:
                raise AssertionError(f"tp={n}: {stats['completed']} "
                                     f"completed, K1 launches {launches} "
                                     f"(want {want} each)")
            cs.check_streams(f"tp{n} bf16", toks, reqs, cfg.vocab_size)
            cs.compare(f"tp{n} bf16", toks, one[0], "bf16",
                       what=f"tp={n} vs tp=1", model=(params, cfg, reqs),
                       firsts_equal=False)
            toks32 = cs.serve(params32, cfg32, reqs32, device=dev,
                              attn_kernel="cuda", tp=n)[0]
            cs.compare(f"tp{n} f32", toks32, one32, "f32",
                       what=f"tp={n} vs tp=1", firsts_equal=False)
        finally:
            group.close()
        rows.append({"tp": n, "devices": list(group.devices),
                     "backend": group.backend, "group_start_s": start_s,
                     "all_reduce_ms": ar_ms, "k1_launches": launches,
                     "ttft_p50_ms": cs.p50(ttft) * 1e3,
                     "tpot_p50_ms": cs.p50(tpot) * 1e3,
                     "tok_s": sum(map(len, toks)) / wall})
        cs.log(json.dumps(rows[-1]))
    cs.log(json.dumps({"ok": True, "cards": cards, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
