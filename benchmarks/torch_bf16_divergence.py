#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s 12 bf16 serving streams part between the K1
kernel engine and the plain gather engine, over several random weight
draws of GPT-2 small, and how far each parting lies from a tie, on one
NVIDIA card.

    python3 benchmarks/torch_bf16_divergence.py [--seeds 6]
        [--faults none pos-1 scale]

Both engines are right; they round attention differently in bf16, and
random weights give near-flat logits, so a greedy stream parts wherever
its top logits come within that rounding. How many streams part is a
property of the weight draw (``init_params(cfg, seed)``, the reference's
draw), so ``chip_smoke.compare`` holds each parting instead: its
distance from a tie (``chip_smoke.tie_ratios``) must be at most 1. To
show that this tells rounding from a fault, each fault but ``none`` is
injected into the kernel engine's K1 calls:

- ``pos-1``: every slot attends one position short (misses its newest
  key);
- ``scale``: K1's output times ``1 + 2**-5``.

The card's name and power limit come first; then one JSON line per seed
and fault: streams parted, the first parting step of each, each
parting's distance from a tie and the largest.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

FAULTS = ("none", "pos-1", "scale")


def faulty_k1(fault: str):
    """K1's wrapper with ``fault`` injected (``FAULTS``)."""
    import torch

    from ray_tpu_torch.models import gpt_decode

    k1 = gpt_decode.paged_attention_cuda
    if fault == "none":
        return k1

    def wrapper(q, kc, vc, pt, pos, page_size, ks=None, vs=None):
        if fault == "pos-1":
            pos = torch.where(pos > 0, pos - 1, pos)
        out = k1(q, kc, vc, pt, pos, page_size, ks, vs)
        return out * (1 + 2 ** -5) if fault == "scale" else out
    return wrapper


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--faults", nargs="+", choices=FAULTS,
                    default=list(FAULTS))
    args = ap.parse_args()
    import torch

    from ray_tpu_torch.models import gpt, gpt_decode

    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    cfg = gpt.CONFIGS["small"]
    reqs = cs.serving_requests()
    dev = torch.device("cuda")
    k1 = gpt_decode.paged_attention_cuda
    for seed in range(args.seeds):
        params = gpt.init_params(cfg, seed, device=dev, dtype=torch.bfloat16)
        ref, *_ = cs.serve(params, cfg, reqs, device=dev,
                           attn_kernel="gather")
        for fault in args.faults:
            gpt_decode.paged_attention_cuda = faulty_k1(fault)
            try:
                got, *_ = cs.serve(params, cfg, reqs, device=dev,
                                   attn_kernel="cuda")
            finally:
                gpt_decode.paged_attention_cuda = k1
            parted = cs.parting_steps(got, ref)
            ratios = cs.tie_ratios((params, cfg, reqs), got, ref, parted)
            print(json.dumps({
                "seed": seed, "fault": fault, "card": card,
                "parted": len(parted), "of": len(reqs),
                "first_step": parted, "tie_ratio": ratios,
                "max_tie_ratio": max(ratios.values(), default=0.0)}),
                flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
