#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the build of every kernel source in this checkout
   (``ray_tpu_torch/ops/csrc/*.cu``, one ``nvcc`` each, started
   together; timed, with ptxas' register/spill report per kernel);
2. K1, the paged-attention kernel (``paged_attention.cu``: split-K over
   page-table columns in a thread-block cluster, TMA page loads), its
   launch plan and how many of its clusters the card holds, held against
   its plain PyTorch version at GPT-2-small decode shapes (16 slots, 12
   heads, head_dim 64, page 16, 64 table columns, mixed lengths up to
   1023, out-of-order and sentinel-padded tables, a mapped page past
   ``pos``), bf16 fp and int8 pools, and timed (device time per call,
   from the profiler) beside the plain version,
   ``scaled_dot_product_attention`` over pre-gathered contiguous K/V and
   the card's bandwidth bound; then held against the plain version and
   timed at the 1b decode shape (16 heads, head_dim 128, 128 columns)
   with skewed lengths (2048, 1025 and 14 slots of at most 65), and
   held against it with pos past the table's last position;
3. K2 and K3 (``flash_attention.cu``: forward, dK/dV, dQ) held against
   their plain versions at the training path's shape (B=32, H=12,
   S=1024, hd=64, bf16, causal; the records' max_abs_err), at B=8, a
   ragged S=1000, non-causal S=256 / Sk=512, and bf16 and f32 at
   head_dim 32 and 128; timed at the training path's shape beside the
   plain versions, SDPA forward and backward (a yardstick timed here
   only; the port never calls it) and the bound, with each kernel's
   achieved TFLOP/s;
4. a small serving reference: the nano model at f32 served on the card
   through K1 gives the same greedy tokens as on the CPU;
5. the engine at full GPT-2-small width (``CONFIGS["small"]``, bf16,
   seeded random weights): 12 concurrent greedy requests through
   ``DecodeEngine(slots=16, chunk=8, max_len=1024, page_size=16,
   attn_kernel="cuda")`` — every stream completes, K1 ran
   ``n_layer * chunk`` times per dispatch, and streams match an
   ``attn_kernel="gather"`` engine on the same card within the stated
   divergence budget; then the same requests with 32 new tokens on an
   int8 pool, and at f32 on fp and int8 pools, where kernel and gather
   engines must agree stream for stream; then a profiled serve window;
6. sampling, the flat pool and speculative decoding (after the threefry
   PRNG was held on the card right after phase 3: split, 32-bit draws
   and uniform bit-equal to the CPU's for lanes from seeds 0, 1,
   2**31-1 and -5 at the serving logits' shape [16, 50304], Gumbel noise
   within ``GUMBEL_ULPS``, and one ``_sample_slots`` call timed):
   temperature 0.8 with per-request seeds (nano f32 card+K1 against the
   CPU under the f32 budget; GPT-2 small bf16, the 12 requests twice,
   identical); the flat pool (``paged=False``) against the paged kernel
   engine under the bf16 budget, nano f32 card equal to the CPU;
   speculative decoding with the n-gram and the model drafter
   (``draft_k=4``, paged, K1) against the plain kernel engine under the
   bf16 budget, with acceptance, tokens per round, TPOT and tok/s beside
   the plain engine's, a ``spec_threshold`` run that falls back to K1
   chunks, and nano f32 spec streams on the card equal to the CPU's;
7. training: the flash and xla attention backends at full width (B=4,
   S=1024) from the same weights and batch (gradients and the loss
   after 2 steps within stated tolerances); nano at f32, 3 steps on the
   card through the kernels against 3 on the CPU through the plain
   versions; then GPT-2 small through ``make_train_step`` at bench.py's
   shape (B=32, S=1024, bf16, ``remat="dots"``, ``attn_backend="flash"``):
   3 warm-up and 10 timed steps, the loss finite and falling, the K2/K3
   launch counts equal to the derived count, tok/s, MFU, peak memory,
   and a profiled step's device busy share.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs one card, no network.
"""
import json
import math
import re
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16 peak
KERNEL_TOL = 1e-2                  # bf16 output: ~1-2 ulp at |x| < 2
# Kernel-engine vs gather-engine streams. Both sum in different orders,
# so an attention output can round one bf16 ulp apart and a greedy
# stream can part at a near-tie: random GPT-2-small weights give flat
# logits. Chip run 2 of PR 1 measured 4 of 12 bf16 streams diverging (at
# steps 4-45) and 3 of 6 int8 streams (at steps 2-15: a rounding
# difference can also move a value across an int8 code boundary).
# Budgets: every first token equal (prefill runs no kernel); at most half
# the bf16 streams and three quarters of the int8 ones diverge; in f32,
# where the two paths differ by ~1e-6 and a flip needs a logit gap that
# small, at most one stream diverges, for fp and int8 pools alike.
#
# Speculative engines commit every token from the verify step, whose
# batched GEMMs (16 slots x 5 positions) round differently from the
# decode step's (16 x 1) in bf16, on top of gathered-einsum vs K1
# attention: on the H100 (PERF.md) 7 of 12 bf16 spec streams parted
# from the plain kernel engine (at steps 4-45), and 0 of 12 at f32
# (spec vs plain, both drafters). Budget for bf16 spec streams: three
# quarters, as int8; at f32 the f32 budget holds them to one stream.
MAX_DIVERGED = {"bf16": 0.5, "int8": 0.75, "f32": 1, "spec_bf16": 0.75}

SOURCE = "ray_tpu_torch/ops/csrc/paged_attention.cu"
REPLACES = "ray_tpu/models/gpt_decode.py:1085"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Time per call of ``fn(i)`` over ``iters`` calls back to back (CUDA
    events around the whole run, after ``warmup`` calls): the device's
    time where it is the longer, else the host's."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of ``fn(i)`` per call: the profiler's time of every
    kernel, copy and memset that ``iters`` calls ran, over ``iters``. A
    short kernel launched back to back runs faster than the host can
    launch it, so CUDA events around the run (:func:`cuda_ms`) would time
    the host; this leaves the host's gaps out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / iters / 1e3


# K1's decode shapes. "small": GPT-2 small's serving engine (16 slots,
# page 16, max_len 1024), mixed lengths up to 1023. "1b": CONFIGS["1b"]'s
# heads at max_seq 2048, skewed lengths: one long slot, one at half, 14
# short ones, where one block per (slot, head) loses most.
K1_SHAPES = {
    "small": dict(H=12, hd=64, ps=16, max_pages=64,
                  pos=[0, 15, 16, 17, 100, 255, 256, 333, 511, 600, 700,
                       800, 900, 1000, 1022, 1023]),
    "1b": dict(H=16, hd=128, ps=16, max_pages=128,
               pos=[2047, 1024, 0, 5, 15, 16, 17, 31, 32, 40, 47, 48, 50,
                    60, 63, 64]),
}


def decode_inputs(shape, kv: str, layers: int = 6, seed: int = 1):
    """One decode step's K1 inputs on the card at ``shape`` (a
    :data:`K1_SHAPES` name or such a dict), bf16 q over bf16 (``kv="fp"``)
    or int8 pools, with ``layers`` layers' pools so that cycling them
    (``args(i)``) reads pages no earlier launch left in the 50 MB L2, as
    in the decode step. Page tables are out of order, sentinel-padded,
    and every third slot maps one page past its length."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from ray_tpu_torch.models.gpt_decode import PT_SENTINEL

    s = K1_SHAPES[shape] if isinstance(shape, str) else shape
    H, hd, ps, max_pages = s["H"], s["hd"], s["ps"], s["max_pages"]
    pos = np.array(s["pos"], np.int32)
    B = len(pos)
    n_pages = B * max_pages + 64
    rng = np.random.default_rng(seed)
    pt = np.full((B, max_pages), PT_SENTINEL, np.int32)
    perm = rng.permutation(n_pages)
    used = 0
    for b in range(B):
        n = min(int(pos[b]) // ps + 1 + (b % 3 == 0), max_pages)
        pt[b, :n] = perm[used:used + n]
        used += n
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, 1, H, hd, device=dev, dtype=torch.bfloat16,
                    generator=gen)
    full = (layers, n_pages, ps, H, hd)
    if kv == "int8":
        kc, vc = (torch.randint(-127, 128, full, device=dev,
                                dtype=torch.int8, generator=gen)
                  for _ in range(2))
        ks, vs = (torch.rand(layers, n_pages, H, device=dev, generator=gen)
                  * 0.02 for _ in range(2))
    else:
        kc, vc = (torch.randn(full, device=dev, dtype=torch.bfloat16,
                              generator=gen) for _ in range(2))
        ks = vs = None
    ptd = torch.from_numpy(pt).to(dev)
    posd = torch.from_numpy(pos).to(dev)

    def args(i):
        l = i % layers
        return (q, kc[l], vc[l], ptd, posd, ps,
                None if ks is None else ks[l], None if vs is None else vs[l])

    return SimpleNamespace(kv=kv, B=B, H=H, hd=hd, ps=ps,
                           max_pages=max_pages, n_pages=n_pages, pt=pt,
                           pos=pos, layers=layers, args=args, q=q, kc=kc,
                           vc=vc, ptd=ptd, posd=posd)


def k1_work(inp) -> dict:
    """What one K1 call must move and compute for these inputs' lengths,
    and the card's least time for it: each live K/V row, q, the output,
    the page table and pos (and the live pages' int8 scales) once over
    the HBM rate; q·k and p·v over the bf16 tensor-core peak."""
    positions = int((inp.pos.astype("int64") + 1).sum())
    elem = 1 if inp.kv == "int8" else 2
    nbytes = (2 * positions * inp.H * inp.hd * elem
              + 2 * inp.B * inp.H * inp.hd * 2
              + inp.pt.nbytes + inp.pos.nbytes)
    if inp.kv == "int8":
        live_pages = int(sum(int(p) // inp.ps + 1 for p in inp.pos))
        nbytes += 2 * live_pages * inp.H * 4
    flops = 4 * positions * inp.H * inp.hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return {"nbytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def max_err(fn, inp) -> float:
    """max |fn - plain| over every layer's pools; raises on a non-finite
    output."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    err = 0.0
    for l in range(inp.layers):
        out = fn(*inp.args(l))
        ref = pa.paged_attention_gather(*inp.args(l))
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"K1 {inp.kv}: non-finite output")
        err = max(err, (out.float() - ref.float()).abs().max().item())
    return err


def kernel_phase(kv: str, card: str) -> dict:
    """K1 vs its plain version, then timings, at GPT-2-small decode shapes
    (``K1_SHAPES["small"]``); then held against the
    plain version and timed at the 1b skewed shape (on a log line; the
    record stays at the serving shape). Six layers' pools are cycled so
    each timed launch reads pages no earlier launch left in the 50 MB
    L2, as in the decode step."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import paged_attention as pa

    inp = decode_inputs("small", kv, seed=1 if kv == "fp" else 2)
    plan = pa._launch_plan(inp.max_pages, inp.ps, inp.hd,
                           inp.kc.element_size())
    clusters = pa._prepare(pa._load(), 1, kv == "int8", inp.hd, inp.ps,
                           inp.max_pages, plan, 0)
    log(f"K1 {kv} plan: {plan} -> grid ({plan.cluster}, {inp.H}, {inp.B}),"
        f" {inp.H * inp.B} clusters of {plan.cluster} blocks x 128 threads;"
        f" the card holds {clusters} clusters at once")
    err = max_err(pa.paged_attention_cuda, inp)
    log(f"K1 {kv}: kernel vs plain max_abs_err={err:.6g} "
        f"(tolerance {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"K1 {kv}: kernel disagrees with plain "
                             f"version: {err} > {KERNEL_TOL}")

    # Device time per call (the profiler's): a launch of K1 is shorter
    # than the host's cost of making one, so events around back-to-back
    # launches time the host (logged beside it as call_ms).
    args = inp.args
    ms = device_ms(lambda i: pa.paged_attention_cuda(*args(i)), 240)
    call_ms = cuda_ms(lambda i: pa.paged_attention_cuda(*args(i)), 240)
    plain_ms = device_ms(lambda i: pa.paged_attention_gather(*args(i)), 30)
    library_ms = None
    if kv == "fp":
        # Pre-gathered contiguous K/V [B, H, V, hd] per layer, masked to
        # <= pos: what a dense attention library call would be handed.
        B, H, hd, V = inp.B, inp.H, inp.hd, inp.max_pages * inp.ps
        ptc = inp.ptd.long().clamp(0, inp.n_pages - 1)
        kd = [inp.kc[l][ptc].reshape(B, V, H, hd).transpose(1, 2)
              .contiguous() for l in range(inp.layers)]
        vd = [inp.vc[l][ptc].reshape(B, V, H, hd).transpose(1, 2)
              .contiguous() for l in range(inp.layers)]
        mask = (torch.arange(V, device=inp.q.device)[None, :]
                <= inp.posd[:, None].long())[:, None, None, :]
        qd = inp.q.transpose(1, 2).contiguous()      # [B, H, 1, hd]
        library_ms = device_ms(lambda i: F.scaled_dot_product_attention(
            qd, kd[i % inp.layers], vd[i % inp.layers], attn_mask=mask),
            240)
        del kd, vd
    work = k1_work(inp)
    rec = {"name": f"paged_attention_{'int8' if kv == 'int8' else 'bf16'}",
           "route": "cuda", "source": SOURCE, "replaces": REPLACES,
           "launches": 0, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
           "bound_by": work["bound_by"], "library_ms": library_ms}
    log(f"K1 {kv} timing [{card}]: kernel_ms={ms:.6g} (device; "
        f"{call_ms:.6g} a call back to back, host included) plain_ms="
        f"{plain_ms:.6g} library_ms={library_ms} bound_ms="
        f"{rec['bound_ms']:.6g} ({rec['bound_by']}: {work['nbytes']} B, "
        f"{work['flops']} flop) roofline_share={rec['bound_ms'] / ms:.3f}")
    del inp
    torch.cuda.empty_cache()

    # The 1b skewed shape: where one block per (slot, head) lost most.
    inp = decode_inputs("1b", kv, seed=3 if kv == "fp" else 4)
    err1b = max_err(pa.paged_attention_cuda, inp)
    ms1b = device_ms(lambda i: pa.paged_attention_cuda(*inp.args(i)), 240)
    work = k1_work(inp)
    log(f"K1 {kv} 1b skewed [{card}] (B={inp.B} H={inp.H} hd={inp.hd} "
        f"page {inp.ps}, {inp.max_pages} columns, lengths "
        f"{(inp.pos + 1).tolist()}; plan "
        f"{pa._launch_plan(inp.max_pages, inp.ps, inp.hd, inp.kc.element_size())}"
        f"): max_abs_err={err1b:.6g} (tolerance {KERNEL_TOL}) kernel_ms="
        f"{ms1b:.6g} bound_ms={work['bound_ms']:.6g} ({work['bound_by']}: "
        f"{work['nbytes']} B) roofline_share={work['bound_ms'] / ms1b:.3f}")
    if not err1b <= KERNEL_TOL:
        raise AssertionError(f"K1 {kv} at the 1b skewed shape: kernel "
                             f"disagrees with plain version: {err1b}")
    del inp
    torch.cuda.empty_cache()

    # pos past the table's last position, as the engine passes it in a
    # request's last chunk: every position of the table is attended.
    inp = decode_inputs(dict(K1_SHAPES["small"], pos=[1026, 1060, 1023, 5]),
                        kv, layers=1, seed=5 if kv == "fp" else 6)
    errp = max_err(pa.paged_attention_cuda, inp)
    log(f"K1 {kv} pos past the table ({inp.max_pages} columns of "
        f"{inp.ps}, pos {inp.pos.tolist()}): max_abs_err={errp:.6g} "
        f"(tolerance {KERNEL_TOL})")
    if not errp <= KERNEL_TOL:
        raise AssertionError(f"K1 {kv} with pos past the table: kernel "
                             f"disagrees with plain version: {errp}")
    del inp
    return rec


FLASH_SOURCE = "ray_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {"flash_attention_fwd": "ray_tpu/ops/flash_attention.py:74",
                  "flash_attention_bwd_dkdv":
                      "ray_tpu/ops/flash_attention.py:152",
                  "flash_attention_bwd_dq": "ray_tpu/ops/flash_attention.py:152"}
# Flash kernels vs their plain versions, as max |kernel - plain| over
# max |plain| per output. f32: the same f32 arithmetic in another order
# (and CUDA's expf), ~1e-6; 1e-4 as the CPU tests hold the plain versions
# to JAX. bf16: the kernels round p to bf16 against each key tile's
# running max and dS per tile, the plain versions against the row's final
# max over one full-width block, so single roundings sit a bf16 ulp
# (2^-8 relative) apart and sums of them drift further; 2e-2 is ~3 ulps
# at the peak. lse is f32 in both (products of bf16 are exact in f32):
# 1e-4 absolute at |lse| ~ 7.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = 1e-4
# (name, dtype, B, H, S, Sk, hd, causal): GPT-2 small at the main path's
# head width, a ragged tail, non-causal with Sk != S, the f32 kernels at
# nano's and 1b's head widths, and the bf16 ones at those widths too.
FLASH_CASES = [
    ("small", "bfloat16", 8, 12, 1024, 1024, 64, True),
    ("ragged", "bfloat16", 2, 12, 1000, 1000, 64, True),
    ("noncausal", "bfloat16", 2, 12, 256, 512, 64, False),
    ("bf16-hd32", "bfloat16", 2, 4, 384, 384, 32, True),
    ("bf16-hd128", "bfloat16", 2, 4, 512, 512, 128, True),
    ("f32-hd32", "float32", 2, 4, 384, 384, 32, True),
    ("f32-hd128", "float32", 2, 4, 256, 256, 128, True),
]
# Training: GPT-2 small at bench.py's shape (bench.py:30-84).
TRAIN_B, TRAIN_S = 32, 1024
# Flash vs xla on the same weights and batch (B=4, full width, bf16): per
# parameter, max |g_flash - g_xla| / max |g_xla|. The two attention paths
# round p and dS to bf16 at different points, and the difference passes
# through 12 layers of bf16 GEMMs; 5e-2 is ~6 bf16 ulps of the peak.
# Loss after 2 AdamW steps: within 2e-2 of ~10.8 (a couple of bf16 ulps of
# the logits' scale, averaged over 4096 tokens).
GRAD_TOL, LOSS2_TOL = 5e-2, 2e-2
NANO_TRAIN_TOL = 1e-5          # f32: card + kernels vs CPU + plain


def build_phase():
    """Build every kernel source (one nvcc each, started together),
    timed, with ptxas' per-kernel registers, spills and performance
    notes (wgmma serialisation). A bf16 flash kernel at head_dim 64 (the
    training path's) that spills is fatal."""
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all(["paged_attention", "flash_attention"])
    log(f"build (nvcc, in parallel): {time.perf_counter() - t0:.3f} s")
    for name, (lib, out) in built.items():
        log(f"  {name} -> {lib}")
        fn = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                # mangled name: keep the kernel's and its template args'
                m = re.search(r"flash_(?:fwd|bwd)_\w+", line)
                k1 = re.search(r"paged_attention_kernelI(\w+?)Lb([01])E",
                               line)
                if m:
                    fn = m.group(0)[:36]
                elif k1:   # mangled T: "f" or "13__nv_bfloat16"
                    t = re.sub(r"^\d+", "", k1.group(1))
                    fn = (f"paged_attention_kernel<{'float' if t == 'f' else t}"
                          f", quant={k1.group(2)}>")
                else:
                    fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}")
                spills = re.search(r"(\d+) bytes spill stores", line)
                if re.match(r"flash_\w+_bf16ILi64E", fn) and spills \
                        and int(spills.group(1)):
                    raise AssertionError(f"{fn} spills at head_dim 64")
            elif "Performance Loss" in line:
                log(f"  ptxas note: {line.split(':', 1)[-1].strip()}")


def _rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _abs_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _flash_hold(case, qs, k, v, do, scale, causal) -> dict:
    """K2, K3a, K3b against their plain versions on one seeded input,
    fatal on disagreement. Returns each kernel's max |kernel - plain|."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_fwd(qs, k, v, causal)
    dq, dk, dv = fa.flash_bwd(qs, k, v, o, lse, do, scale, causal)
    ro, rlse = fa.flash_fwd_plain(qs, k, v, causal)
    rdq, rdk, rdv = fa.flash_bwd_plain(qs, k, v, o, lse, do, scale, causal)
    torch.cuda.synchronize()
    for t in (o, lse, dq, dk, dv):
        if not torch.isfinite(t).all():
            raise AssertionError(f"flash {case}: non-finite output")
    rel = {"o": _rel_err(o, ro), "dq": _rel_err(dq, rdq),
           "dk": _rel_err(dk, rdk), "dv": _rel_err(dv, rdv)}
    lse_err = _abs_err(lse, rlse)
    tol = FLASH_TOL[str(qs.dtype).split(".")[-1]]
    B, S, H, hd = qs.shape
    log(f"flash {case} ({qs.dtype}, B={B} H={H} S={S} Sk={k.shape[1]} "
        f"hd={hd} causal={causal}): kernel vs plain relative err "
        + " ".join(f"{n}={e:.3g}" for n, e in rel.items())
        + f", lse abs err={lse_err:.3g} (tolerance {tol}, lse {LSE_TOL})")
    if max(rel.values()) > tol or not lse_err <= LSE_TOL:
        raise AssertionError(f"flash {case}: kernel disagrees with the "
                             f"plain version")
    errs = {"flash_attention_fwd": _abs_err(o, ro),
            "flash_attention_bwd_dkdv": max(_abs_err(dk, rdk),
                                            _abs_err(dv, rdv)),
            "flash_attention_bwd_dq": _abs_err(dq, rdq)}
    log(f"flash {case}: max_abs_err {errs} (peaks: o "
        f"{ro.float().abs().max().item():.3g}, dk "
        f"{rdk.float().abs().max().item():.3g}, dv "
        f"{rdv.float().abs().max().item():.3g}, dq "
        f"{rdq.float().abs().max().item():.3g})")
    return errs


def flash_kernel_phase(card: str) -> list:
    """K2, K3a, K3b against their plain versions on the card at the
    shapes of FLASH_CASES and at the training path's shape (B=32, H=12,
    S=1024, hd=64, bf16, causal), whose errors go into the records; then
    timed at that shape beside the plain versions, SDPA (a yardstick
    timed here only; the port never calls it) and the card's bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    for i, (case, dt, B, H, S, Sk, hd, causal) in enumerate(FLASH_CASES):
        td = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(10 + i)
        qs, k, v, do = (torch.randn(B, n, H, hd, device=dev, generator=gen)
                        .to(td) for n in (S, Sk, Sk, S))
        scale = 1.0 / np.sqrt(hd)
        _flash_hold(case, fa.scale_q(qs, scale), k, v, do, scale, causal)
        del qs, k, v, do

    # The training path's shape: held against the plain versions (these
    # errors are the records'), then timed.
    B, H, S, hd = TRAIN_B, 12, TRAIN_S, 64
    gen = torch.Generator(device=dev).manual_seed(20)
    qs, k, v, do = (torch.randn(B, S, H, hd, device=dev, generator=gen)
                    .to(torch.bfloat16) for _ in range(4))
    scale = 0.125
    qs = fa.scale_q(qs, scale)
    errs = _flash_hold("train", qs, k, v, do, scale, True)
    torch.cuda.empty_cache()
    o, lse = fa.flash_fwd(qs, k, v, True)
    delta = fa._delta(do, o).contiguous()
    ms = {
        "flash_attention_fwd": cuda_ms(lambda i: fa.flash_fwd(qs, k, v,
                                                              True), 50),
        "flash_attention_bwd_dkdv": cuda_ms(lambda i: fa._launch_dkdv(
            qs, k, v, do, lse, delta, True), 50),
        "flash_attention_bwd_dq": cuda_ms(lambda i: fa._launch_dq(
            qs, k, v, do, lse, delta, scale, True), 50),
    }
    plain_fwd = cuda_ms(lambda i: fa.flash_fwd_plain(qs, k, v, True), 5, 1)
    plain_bwd = cuda_ms(lambda i: fa.flash_bwd_plain(
        qs, k, v, o, lse, do, scale, True), 5, 1)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                       for t in (qs, k, v, do))
    lib_fwd = cuda_ms(lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=1.0), 50)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))

    def sdpa_fwd_bwd(i):
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             scale=1.0)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    lib_bwd = cuda_ms(sdpa_fwd_bwd, 50) - lib_fwd
    # Bound: each input read once, each output written once, over HBM
    # rate; the products' flops for the visible (q, k) pairs over the
    # bf16 tensor-core peak.
    pairs = B * H * S * (S + 1) // 2
    t_elems = B * S * H * hd * 2                     # one bf16 tensor
    stats = B * H * S * 4                            # one f32 [B, H, S]
    work = {"flash_attention_fwd": (4 * t_elems + stats, 4 * hd * pairs),
            "flash_attention_bwd_dkdv": (6 * t_elems + 2 * stats,
                                         8 * hd * pairs),
            "flash_attention_bwd_dq": (5 * t_elems + 2 * stats,
                                       6 * hd * pairs)}
    records = []
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        fwd = name == "flash_attention_fwd"
        rec = {"name": name, "route": "cuda", "source": FLASH_SOURCE,
               "replaces": FLASH_REPLACES[name], "launches": 0,
               "max_abs_err": errs[name], "ms": ms[name],
               "plain_ms": plain_fwd if fwd else plain_bwd,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_fwd if fwd else lib_bwd}
        log(f"{name} timing [{card}] (B={B} H={H} S={S} hd={hd} bf16 "
            f"causal): kernel_ms={rec['ms']:.6g} "
            f"({flops / rec['ms'] / 1e9:.1f} TFLOP/s over {pairs} visible "
            f"pairs) plain_ms={rec['plain_ms']:.6g} library_ms="
            f"{rec['library_ms']:.6g} bound_ms={rec['bound_ms']:.6g} "
            f"({rec['bound_by']}: {nbytes} B, {flops} flop) roofline_share="
            f"{rec['bound_ms'] / rec['ms']:.3f}")
        records.append(rec)
    log(f"flash backward [{card}]: K3a + K3b = "
        f"{ms['flash_attention_bwd_dkdv'] + ms['flash_attention_bwd_dq']:.6g}"
        f" ms (plus delta) against the plain backward {plain_bwd:.6g} ms and"
        f" SDPA's backward {lib_bwd:.6g} ms (both compute dq, dk, dv)")
    del qs, k, v, do, o, lse, delta, qt, kt, vt, dot, qg, kg, vg
    torch.cuda.empty_cache()
    return records


def _train_batch(cfg, B, S, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(
        0, min(cfg.vocab_size, 50257), (B, S + 1))).to(device)}


def train_phase(card: str) -> dict:
    """GPT-2 small trained through ``make_train_step`` at bench.py's
    shape with the flash kernels: 3 warm-up steps, then 10 timed steps on
    one repeated batch, the counts set to 0 just before them. Then one
    profiled step. Returns the launches counted in the timed steps."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(gpt.CONFIGS["small"], remat="dots",
                              attn_backend="flash")
    init, step = gpt.make_train_step(cfg, device="cuda")
    state = init(seed=0)
    batch = _train_batch(cfg, TRAIN_B, TRAIN_S, 5, "cuda")
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    fa.launches.update(dict.fromkeys(fa.launches, 0))
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    L = cfg.n_layer
    # Per step: K2 once per layer in forward and once more per layer when
    # the remat policy recomputes the block (dots and full do: the flash
    # call is not a matrix product); K3a and K3b once per layer.
    recompute = gpt._remat_policy(cfg.remat) != "none"
    want = {"flash_attention_fwd": iters * L * (2 if recompute else 1),
            "flash_attention_bwd_dkdv": iters * L,
            "flash_attention_bwd_dq": iters * L}
    tok_s = TRAIN_B * TRAIN_S * iters / dt
    flops_tok = 6 * cfg.num_params() + 12 * L * TRAIN_S * cfg.d_model
    mfu = tok_s * flops_tok / BF16_FLOPS
    log(f"train small bf16 [{card}] (B={TRAIN_B}, S={TRAIN_S}, remat=dots, "
        f"flash): {tok_s:.1f} tok/s, step {dt / iters * 1e3:.3f} ms, MFU "
        f"{mfu:.4f} (bench.py FLOPs/token {flops_tok} over {BF16_FLOPS:g}),"
        f" peak memory {peak / 2**30:.3f} GiB")
    log(f"train losses: {[round(x, 4) for x in losses]}")
    log(f"train launches in {iters} steps: {counts} (want {want}: "
        f"n_layer={L} x (2 if remat recomputes else 1) K2, n_layer each "
        f"K3a/K3b, per step)")
    if not all(map(math.isfinite, losses)):
        raise AssertionError("training loss is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    if counts != want:
        raise AssertionError(f"flash launches {counts} != {want}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms, rows = device_rows(prof)
    if busy_ms == 0:
        log("train profile: the profiler recorded no device time; device "
            "busy share not measured")
    else:
        log(f"train profile [{card}]: one step, device busy {busy_ms:.3f} "
            f"ms of {wall * 1e3:.3f} ms wall (profiled) = "
            f"{busy_ms / (wall * 1e3):.3f}, idle "
            f"{1 - busy_ms / (wall * 1e3):.3f}")
        for us, key, count in sorted(rows, reverse=True)[:10]:
            log(f"  {us / 1e3:10.3f} ms  {count:6d} x  {key[:90]}")
        flash = []
        for us, key, count in sorted(rows):
            m = re.search(r"flash_(fwd|bwd_dkdv|bwd_dq)_bf16", key)
            if m:
                flash.append((us, f"{m.group(0)} {us / 1e3:.3f} ms x {count}"))
        log(f"train profile: K2/K3 {sum(us for us, _ in flash) / 1e3:.3f} "
            f"ms of the step: " + "; ".join(text for _, text in flash))
    del state
    torch.cuda.empty_cache()
    return counts


def flash_vs_xla_phase(card: str) -> None:
    """The flash and xla attention backends on the card, full GPT-2-small
    width, B=4, S=1024, bf16, the same weights and batch: per-parameter
    gradient error and the loss after 2 steps."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt

    base = gpt.CONFIGS["small"]
    batch = _train_batch(base, 4, TRAIN_S, 6, "cuda")
    grads, loss2 = {}, {}
    for backend in ("flash", "xla"):
        cfg = dataclasses.replace(base, attn_backend=backend)
        init, step = gpt.make_train_step(cfg, device="cuda")
        state = init(seed=0)
        loss, _ = gpt.loss_fn(state["params"], batch, cfg)
        loss.backward()
        grads[backend] = {n: p.grad.detach().clone()
                          for n, p in state["params"].items()}
        for _ in range(2):
            state, m = step(state, batch)
        loss2[backend] = float(m["loss"])
        del state
    errs = {n: _rel_err(grads["flash"][n], grads["xla"][n])
            for n in grads["xla"]}
    worst = max(errs, key=errs.get)
    dl = abs(loss2["flash"] - loss2["xla"])
    log(f"flash vs xla [{card}] (small, B=4, S={TRAIN_S}, bf16): gradient "
        f"relative err max {errs[worst]:.4g} ({worst}; tolerance "
        f"{GRAD_TOL}); loss after 2 steps flash {loss2['flash']:.6f} xla "
        f"{loss2['xla']:.6f} |diff| {dl:.3g} (tolerance {LOSS2_TOL})")
    if errs[worst] > GRAD_TOL or not dl <= LOSS2_TOL:
        raise AssertionError("flash and xla training disagree beyond the "
                             "stated tolerance")
    del grads
    torch.cuda.empty_cache()


def nano_train_phase() -> None:
    """nano at f32: 3 steps on the card through the kernels against 3
    steps on the CPU through the plain versions, same weights and batch."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.float32,
                              attn_backend="flash")
    weights = gpt.init_params(cfg, seed=0, device="cpu")
    losses = {}
    for device in ("cpu", "cuda"):
        init, step = gpt.make_train_step(cfg, device=device)
        state = init(params=weights)
        batch = _train_batch(cfg, 8, 128, 7, device)
        before = dict(fa.launches)
        out = []
        for _ in range(3):
            state, m = step(state, batch)
            out.append(float(m["loss"]))
        losses[device] = out
        ran = {n: fa.launches[n] - before[n] for n in before}
        if device == "cuda" and not all(ran.values()):
            raise AssertionError(f"nano on the card skipped a kernel: {ran}")
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"nano f32 training: card+kernels {losses['cuda']} vs CPU+plain "
        f"{losses['cpu']}, max |diff| {diff:.3g} (tolerance "
        f"{NANO_TRAIN_TOL})")
    if not diff <= NANO_TRAIN_TOL:
        raise AssertionError("nano f32 training: card and CPU disagree")


def serve(params, cfg, reqs, *, device, attn_kernel=None, seeds=None,
          slots=16, chunk=8, max_len=1024, page_size=16, **engine_kw):
    """Queue every request (``seeds[i]`` seeds request i's PRNG lane),
    start the driver, drain all streams from their own threads. Other
    keywords go to the engine (``kv_dtype``, ``temperature``, ``paged``,
    ``spec_decode``, ...). Returns (streams, ttft_s, tpot_s, wall_s,
    stats)."""
    import numpy as np
    import torch

    from ray_tpu_torch.serve.engine import DecodeEngine

    eng = DecodeEngine(params, cfg, slots=slots, chunk=chunk,
                       max_len=max_len, page_size=page_size,
                       attn_kernel=attn_kernel, device=device,
                       auto_start=False, **engine_kw)
    seeds = seeds or [0] * len(reqs)
    try:
        streams = [eng.stream(p, m, seed=s)
                   for (p, m), s in zip(reqs, seeds)]
        outs = [[] for _ in reqs]
        stamps = [[] for _ in reqs]
        errors = []

        def consume(i):
            try:
                for piece in streams[i]:
                    stamps[i].append(time.perf_counter())
                    outs[i].append(piece)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=consume, args=(i,), daemon=True)
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"{attn_kernel} {engine_kw} engine: "
                               f"streams did not finish within 600 s")
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        stats = eng.stats()
    finally:
        eng.shutdown()
    toks = [np.concatenate(o) for o in outs]
    ttft = [s[0] - t0 for s in stamps]
    tpot = [(s[-1] - s[0]) / max(len(t) - 1, 1)
            for s, t in zip(stamps, toks)]
    return toks, ttft, tpot, wall, stats


def device_rows(prof):
    """(device busy ms, [(us, name, count)]) from the profiler's device
    events only (kernels, copies, memsets). A host op's own device time
    is the time of the kernels it launched, so summing host ops and
    kernels together would count each kernel twice."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sum(r[0] for r in rows) / 1e3, rows


def profile_phase(params, cfg, reqs, card):
    """Where a serve window's time goes on the card: the profiler's device
    time by kernel over the window's wall time (the profiler's own host
    cost inflates the wall, so the idle share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        toks, _, _, wall, stats = serve(params, cfg, reqs,
                                        device=torch.device("cuda"),
                                        attn_kernel="cuda")
    busy_ms, rows = device_rows(prof)
    if busy_ms == 0:
        log("profile: the profiler recorded no device time; device busy "
            "share not measured")
        return
    log(f"profile [{card}]: {len(reqs)} requests, "
        f"{sum(map(len, toks))} tokens, {stats['dispatches']} dispatches "
        f"in {wall * 1e3:.3f} ms wall (profiled); device busy "
        f"{busy_ms:.3f} ms = {busy_ms / (wall * 1e3):.3f} of the wall, "
        f"idle {1 - busy_ms / (wall * 1e3):.3f}")
    for us, key, count in sorted(rows, reverse=True)[:8]:
        log(f"  {us / 1e3:10.3f} ms  {count:6d} x  {key[:90]}")


def check_streams(name, toks, reqs, vocab):
    for i, (t, (_, m)) in enumerate(zip(toks, reqs)):
        if t.shape != (m,) or t.min() < 0 or t.max() >= vocab:
            raise AssertionError(f"{name}: stream {i} malformed: shape "
                                 f"{t.shape} (want {(m,)})")


def compare(name, got, ref, precision, what="kernel vs gather"):
    firsts = all(g[0] == r[0] for g, r in zip(got, ref))
    diverged = [i for i, (g, r) in enumerate(zip(got, ref))
                if not np_equal(g, r)]
    where = {i: int((got[i] != ref[i]).argmax()) for i in diverged}
    budget = MAX_DIVERGED[precision]
    if isinstance(budget, float):
        budget = int(budget * len(got))
    log(f"{name}: {what} streams: {len(diverged)}/{len(got)} "
        f"diverge (budget {budget}), first divergence at {where}, first "
        f"tokens all equal: {firsts}")
    if not firsts or len(diverged) > budget:
        raise AssertionError(f"{name}: {what} outside the divergence "
                             f"budget")


#: Gumbel noise on the card against the CPU: ``log`` may round one ulp
#: apart between devices, and an ulp of the inner ``-log(u)`` reaches the
#: result as an absolute 2**-23 (``tests/test_torch_prng.py`` holds the
#: CPU against ``jax.random`` to the same bound).
GUMBEL_ULPS = 4
PRNG_SEEDS = (0, 1, 2 ** 31 - 1, -5)
SAMPLE_SHAPE = (16, 50304)          # the serving pool's logits


def prng_phase(card: str) -> None:
    """The threefry PRNG on the card: split, 32-bit draws and uniform
    bit-equal to the CPU's, Gumbel noise within ``GUMBEL_ULPS``, for 16
    lanes split from each of ``PRNG_SEEDS`` at the serving shape; then
    the device and host time of one ``_sample_slots`` call there."""
    import numpy as np
    import torch

    from ray_tpu_torch._private import prng
    from ray_tpu_torch.models import gpt_decode as gd

    B, V = SAMPLE_SHAPE
    for seed in PRNG_SEEDS:
        root = torch.from_numpy(prng.PRNGKey(seed).astype(np.int64))
        lanes = prng.split(root, B)                             # [16, 2]
        out = {}
        for dev in ("cpu", "cuda"):
            k = lanes.to(dev)
            out[dev] = [t.cpu() for t in (
                prng.split(k), prng.random_bits(k, (V,)),
                prng.uniform(k, (V,)), prng.gumbel(k, (V,)))]
        for name, a, b in zip(("split", "bits", "uniform"),
                              out["cuda"], out["cpu"]):
            if not torch.equal(a, b):
                raise AssertionError(f"prng {name}, seed {seed}: the card "
                                     f"differs from the CPU")
        g_cpu = out["cpu"][3].numpy()
        ulps = np.abs(out["cuda"][3].numpy() - g_cpu) / (
            np.spacing(np.abs(g_cpu)) + 2.0 ** -23)
        log(f"prng seed {seed}: split/bits/uniform bit-equal card vs CPU "
            f"at [{B}, {V}]; gumbel worst {ulps.max():.3g} "
            f"(ulp + 2**-23) units, {(ulps > 0).mean():.4f} of values "
            f"differ (bound {GUMBEL_ULPS})")
        if ulps.max() > GUMBEL_ULPS:
            raise AssertionError(f"prng gumbel, seed {seed}: card vs CPU "
                                 f"beyond {GUMBEL_ULPS} units")
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(SAMPLE_SHAPE, device="cuda", generator=gen) * 3
    keys = lanes.cuda()

    def sample(_):
        gd._sample_slots(logits, 0.8, keys)

    dev_ms = device_ms(sample, 20)
    greedy_ms = device_ms(lambda _: gd._sample_slots(logits), 20)
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(0)
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    log(f"_sample_slots [{B}, {V}] at T=0.8 [{card}]: device "
        f"{dev_ms:.5g} ms per call (profiler); host {p50(host) * 1e3:.5g} "
        f"ms per call (p50 of 10 enqueues on an idle queue); greedy "
        f"argmax {greedy_ms:.5g} ms device")


def sampling_phase(params, cfg, reqs, nano_args, card) -> None:
    """Temperature 0.8 with per-request seeds. Nano f32: streams on the
    card (paged, K1) against the CPU plain path, under the f32 budget.
    GPT-2 small bf16, the 12-request mix: well-formed streams, K1 on
    every decode step, the same seeds twice give the same streams."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    p_nano, nano, small, kw = nano_args
    seeds = [3, 5, 2 ** 31 - 1, -7]
    ref, *_ = serve(p_nano, nano, small, device=torch.device("cpu"),
                    attn_kernel="gather", temperature=0.8, seeds=seeds,
                    **kw)
    got, *_ = serve(p_nano, nano, small, device=torch.device("cuda"),
                    attn_kernel="cuda", temperature=0.8, seeds=seeds, **kw)
    check_streams("nano T=0.8", got, small, nano.vocab_size)
    compare("nano f32 T=0.8", got, ref, "f32",
            what="card+kernel vs CPU+plain")
    dev = torch.device("cuda")
    seeds = [1000 + i for i in range(len(reqs))]
    runs = []
    for _ in range(2):
        pa.launches = 0
        toks, _, tpot, wall, st = serve(params, cfg, reqs, device=dev,
                                        attn_kernel="cuda", temperature=0.8,
                                        seeds=seeds)
        check_streams("small bf16 T=0.8", toks, reqs, cfg.vocab_size)
        want = cfg.n_layer * 8 * st["dispatches"]
        if pa.launches != want or st["completed"] != len(reqs):
            raise AssertionError(f"T=0.8 engine: launches {pa.launches} "
                                 f"(want {want}), completed "
                                 f"{st['completed']}")
        runs.append(toks)
        n = sum(map(len, toks))
        log(f"small bf16 T=0.8 engine [{card}]: {n / wall:.2f} tok/s; "
            f"TPOT p50 {p50(tpot) * 1e3:.3f} ms; K1 launches "
            f"{pa.launches}")
    if not all(np_equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("T=0.8: the same seeds gave other streams")
    log(f"small bf16 T=0.8: {len(reqs)} seeded streams identical in two "
        f"runs")


def flat_phase(params, cfg, reqs, greedy, nano_args, card) -> None:
    """The flat pool (``paged=False``): GPT-2 small bf16 on the 12-request
    mix against the paged kernel engine's streams under the bf16 budget;
    nano f32 on the card equal to the CPU's."""
    import torch

    p_nano, nano, small, kw = nano_args
    toks, _, tpot, wall, st = serve(params, cfg, reqs,
                                    device=torch.device("cuda"),
                                    paged=False)
    check_streams("small bf16 flat", toks, reqs, cfg.vocab_size)
    if st["paged"] or st["completed"] != len(reqs):
        raise AssertionError(f"flat engine: {st}")
    compare("small bf16 flat", toks, greedy, "bf16",
            what="flat vs paged-kernel")
    log(f"small bf16 flat engine [{card}]: "
        f"{sum(map(len, toks)) / wall:.2f} tok/s; TPOT p50 "
        f"{p50(tpot) * 1e3:.3f} ms")
    kw = dict(kw, paged=False)
    ref, *_ = serve(p_nano, nano, small, device=torch.device("cpu"), **kw)
    got, *_ = serve(p_nano, nano, small, device=torch.device("cuda"), **kw)
    if not all(np_equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"nano f32 flat: card streams differ from "
                             f"the CPU's: {got} vs {ref}")
    log("nano f32 flat: card streams == CPU streams")


def spec_phase(params, cfg, reqs, greedy, greedy_stats, f32_args,
               nano_args, card) -> None:
    """Speculative decoding, GPT-2 small, paged, K1 engine, ``draft_k=4``,
    temperature 0, with each drafter: bf16 streams against the
    non-speculative kernel engine's under the ``spec_bf16`` budget
    (verify's arithmetic rounds differently from decode's, so the two
    part at near-ties), acceptance, tokens per verify round, TPOT and
    tok/s beside the plain engine's; the same at f32 (the f32 requests),
    held to the f32 budget. Then a ``spec_threshold`` run that always
    falls back to the chunk step (K1 from a spec engine), and nano f32
    spec streams on the card equal to the CPU's."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    g_tpot, g_tps = greedy_stats
    for drafter in ("ngram", "model"):
        toks, _, tpot, wall, st = serve(params, cfg, reqs, device=dev,
                                        attn_kernel="cuda",
                                        spec_decode=drafter, draft_k=4)
        check_streams(f"small bf16 spec {drafter}", toks, reqs,
                      cfg.vocab_size)
        compare(f"small bf16 spec {drafter}", toks, greedy, "spec_bf16",
                what="spec vs plain kernel engine")
        sp = st["spec"]
        log(f"small bf16 spec {drafter} [{card}]: acceptance "
            f"{sp['acceptance_rate']:.4f}, tokens per lane per verify "
            f"{sp['accepted_per_forward']:.4f}, {sp['rounds']} rounds; "
            f"TPOT p50 {p50(tpot) * 1e3:.3f} ms (plain {g_tpot * 1e3:.3f}); "
            f"{sum(map(len, toks)) / wall:.2f} tok/s (plain {g_tps:.2f})")
    params32, cfg32, reqs32, plain32 = f32_args
    for drafter in ("ngram", "model"):
        toks, _, tpot, wall, st = serve(params32, cfg32, reqs32, device=dev,
                                        attn_kernel="cuda",
                                        spec_decode=drafter, draft_k=4)
        check_streams(f"small f32 spec {drafter}", toks, reqs32,
                      cfg.vocab_size)
        compare(f"small f32 spec {drafter}", toks, plain32, "f32",
                what="spec vs plain kernel engine")
        log(f"small f32 spec {drafter} [{card}]: acceptance "
            f"{st['spec']['acceptance_rate']:.4f}; TPOT p50 "
            f"{p50(tpot) * 1e3:.3f} ms")
    pa.launches = 0
    toks, _, _, _, st = serve(params, cfg, reqs, device=dev,
                              attn_kernel="cuda", spec_decode="ngram",
                              spec_threshold=100.0)
    sp = st["spec"]
    if not sp["fallback_rounds"] or sp["rounds"] or not pa.launches:
        raise AssertionError(f"spec_threshold fallback: {sp}, K1 launches "
                             f"{pa.launches}")
    compare("small bf16 spec fallback", toks, greedy, "bf16",
            what="fallback vs plain kernel engine")
    log(f"small bf16 spec fallback: {sp['fallback_rounds']} chunk rounds, "
        f"K1 launches {pa.launches}")
    p_nano, nano, small, kw = nano_args
    for drafter in ("ngram", "model"):
        ref, *_ = serve(p_nano, nano, small, device=torch.device("cpu"),
                        attn_kernel="gather", spec_decode=drafter, **kw)
        got, *_ = serve(p_nano, nano, small, device=dev, attn_kernel="cuda",
                        spec_decode=drafter, **kw)
        if not all(np_equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"nano f32 spec {drafter}: card streams "
                                 f"differ from the CPU's")
    log("nano f32 spec (ngram, model): card streams == CPU streams")


def np_equal(a, b):
    return a.shape == b.shape and bool((a == b).all())


def p50(xs):
    import numpy as np

    return float(np.percentile(np.asarray(xs), 50))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import paged_attention as pa

    card = card_line()
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {name}, capability "
        f"{torch.cuda.get_device_capability(0)}")

    # ---- 1. build
    build_phase()

    # ---- 2-3. kernels vs plain, timings
    records = [kernel_phase("fp", card), kernel_phase("int8", card)]
    flash_records = flash_kernel_phase(card)
    prng_phase(card)

    # ---- 4. small reference: nano f32, card+kernel vs CPU+plain
    nano = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.float32)
    rng = np.random.default_rng(3)
    small = [(rng.integers(0, nano.vocab_size, (n,)).astype(np.int32), 16)
             for n in (5, 16, 33, 70)]
    kw = dict(slots=4, chunk=4, max_len=128, page_size=8)
    p_cpu = gpt.init_params(nano, seed=0, device="cpu")
    ref, *_ = serve(p_cpu, nano, small, device=torch.device("cpu"),
                    attn_kernel="gather", **kw)
    got, *_ = serve(p_cpu, nano, small, device=torch.device("cuda"),
                    attn_kernel="cuda", **kw)
    check_streams("nano", got, small, nano.vocab_size)
    if not all(np_equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"nano f32: card+kernel streams differ from "
                             f"CPU+plain: {got} vs {ref}")
    log("nano f32 reference: card+kernel streams == CPU+plain streams "
        f"({len(small)} streams x 16 tokens)")
    nano_args = (p_cpu, nano, small, kw)

    # ---- 5. the engine at GPT-2-small width
    cfg = gpt.CONFIGS["small"]
    params = gpt.init_params(cfg, seed=0, device="cuda",
                             dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    sysp = rng.integers(0, 50257, (250,)).astype(np.int32)
    lens = [16, 24, 48, 64, 96, 128, 200, 320, 400, 512]
    prompts = [rng.integers(0, 50257, (n,)).astype(np.int32) for n in lens]
    prompts += [np.concatenate([sysp, rng.integers(0, 50257, (n,))]
                               ).astype(np.int32) for n in (40, 60)]
    reqs = [(p, int(m)) for p, m in
            zip(prompts, rng.integers(32, 65, len(prompts)))]
    dev = torch.device("cuda")
    # Warm cuBLAS and the allocator on a throwaway run.
    serve(params, cfg, reqs[:2], device=dev, attn_kernel="gather")
    ref, _, _, ref_wall, ref_stats = serve(params, cfg, reqs, device=dev,
                                           attn_kernel="gather")
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    toks, ttft, tpot, wall, stats = serve(params, cfg, reqs, device=dev,
                                          attn_kernel="cuda")
    launches_fp = pa.launches
    peak = torch.cuda.max_memory_allocated()
    check_streams("small bf16", toks, reqs, cfg.vocab_size)
    if stats["completed"] != len(reqs):
        raise AssertionError(f"only {stats['completed']} of {len(reqs)} "
                             f"streams completed")
    want = cfg.n_layer * 8 * stats["dispatches"]
    log(f"small bf16: launches={launches_fp} dispatches="
        f"{stats['dispatches']} (want n_layer*chunk*dispatches={want}), "
        f"prefix_hits={stats['prefix_hits']}")
    if launches_fp != want or launches_fp == 0:
        raise AssertionError("the kernel did not run on every decode step")
    check_streams("small bf16 gather", ref, reqs, cfg.vocab_size)
    compare("small bf16", toks, ref, "bf16")
    n_tok = sum(len(t) for t in toks)
    log(f"small bf16 engine [{card}]: {len(reqs)} requests, {n_tok} "
        f"tokens in {wall:.4f} s = {n_tok / wall:.2f} tok/s; TTFT p50 "
        f"{p50(ttft) * 1e3:.3f} ms; TPOT p50 {p50(tpot) * 1e3:.3f} ms; "
        f"peak memory {peak / 2**20:.1f} MiB; gather engine "
        f"{n_tok / ref_wall:.2f} tok/s")
    records[0]["launches"] = launches_fp

    reqs32 = [(p, 32) for p, _ in reqs]
    ref8, *_ = serve(params, cfg, reqs32, device=dev, attn_kernel="gather",
                     kv_dtype="int8")
    pa.launches = 0
    toks8, ttft8, tpot8, wall8, stats8 = serve(
        params, cfg, reqs32, device=dev, attn_kernel="cuda",
        kv_dtype="int8")
    launches_i8 = pa.launches
    check_streams("small int8", toks8, reqs32, cfg.vocab_size)
    want8 = cfg.n_layer * 8 * stats8["dispatches"]
    if stats8["completed"] != len(reqs32) or launches_i8 != want8 \
            or launches_i8 == 0:
        raise AssertionError(f"int8 run: completed {stats8['completed']}, "
                             f"launches {launches_i8} (want {want8})")
    compare("small int8", toks8, ref8, "int8")
    n8 = sum(len(t) for t in toks8)
    log(f"small int8 engine [{card}]: {len(reqs32)} requests, {n8} tokens "
        f"in {wall8:.4f} s = {n8 / wall8:.2f} tok/s; TTFT p50 "
        f"{p50(ttft8) * 1e3:.3f} ms; TPOT p50 {p50(tpot8) * 1e3:.3f} ms; "
        f"launches={launches_i8}")
    records[1]["launches"] = launches_i8

    # The same requests at f32, fp and int8 pools: kernel and gather
    # engines must agree stream for stream at full width.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = gpt.init_params(cfg32, seed=0, device="cuda")
    plain32 = {}
    for kv in ("fp", "int8"):
        ref32, *_ = serve(params32, cfg32, reqs32, device=dev,
                          attn_kernel="gather", kv_dtype=kv)
        toks32, _, tpot32, wall32, _ = serve(
            params32, cfg32, reqs32, device=dev, attn_kernel="cuda",
            kv_dtype=kv)
        plain32[kv] = toks32
        check_streams(f"small f32 {kv}", toks32, reqs32, cfg.vocab_size)
        compare(f"small f32 {kv}", toks32, ref32, "f32")
        log(f"small f32 {kv} engine [{card}]: "
            f"{sum(map(len, toks32)) / wall32:.2f} tok/s; TPOT p50 "
            f"{p50(tpot32) * 1e3:.3f} ms")

    profile_phase(params, cfg, reqs32[:6], card)

    # ---- 6. sampling at T > 0, the flat pool, speculative decoding
    sampling_phase(params, cfg, reqs, nano_args, card)
    flat_phase(params, cfg, reqs, toks, nano_args, card)
    spec_phase(params, cfg, reqs, toks, (p50(tpot), n_tok / wall),
               (params32, cfg32, reqs32, plain32["fp"]), nano_args, card)
    del params, params32
    torch.cuda.empty_cache()

    # ---- 7. training: flash vs xla, nano f32 card vs CPU, GPT-2 small
    flash_vs_xla_phase(card)
    nano_train_phase()
    counts = train_phase(card)
    for rec in flash_records:
        rec["launches"] = counts[rec["name"]]
    records += flash_records

    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
