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
4. a small serving reference: ``init_params(nano)`` on the card
   bit-equal to the CPU's (the reference's weights), and the nano model
   at f32 served on the card through K1 gives the same greedy tokens as
   on the CPU;
5. the engine at full GPT-2-small width (``CONFIGS["small"]``, bf16,
   the reference's random weights for seed 0, drawn on the card and
   timed): 12 concurrent greedy requests through
   ``DecodeEngine(slots=16, chunk=8, max_len=1024, page_size=16,
   attn_kernel="cuda")`` — every stream completes, K1 ran
   ``n_layer * chunk`` times per dispatch, and streams match an
   ``attn_kernel="gather"`` engine on the same card wherever the f32
   logits have no bf16 near-tie (``TIE_ERRS``); then the same requests
   with 32 new tokens on an int8 pool, and at f32 on fp and int8 pools,
   where kernel and gather engines must agree stream for stream; then a profiled serve window;
6. sampling, the flat pool and speculative decoding (after the threefry
   PRNG was held on the card right after phase 3: split, 32-bit draws,
   uniform and normal bit-equal to the CPU's for lanes from seeds 0, 1,
   2**31-1 and -5 at the serving logits' shape [16, 50304], Gumbel noise
   within ``GUMBEL_ULPS``, and one ``_sample_slots`` call timed):
   temperature 0.8 with per-request seeds (nano f32 card+K1 against the
   CPU under the f32 budget; GPT-2 small bf16, the 12 requests twice,
   identical); the flat pool (``paged=False``) against the paged kernel
   engine with bf16 near-ties only, nano f32 card equal to the CPU;
   speculative decoding with the n-gram and the model drafter
   (``draft_k=4``, paged, K1) against the plain kernel engine with bf16
   near-ties only, with acceptance, tokens per round, TPOT and tok/s beside
   the plain engine's, a ``spec_threshold`` run that falls back to K1
   chunks, and nano f32 spec streams on the card equal to the CPU's;
   then disaggregated prefill/decode on the 12 requests: a
   ``role="prefill"`` engine hands each off and a ``role="decode"`` K1
   engine imports it, paged to paged (fp and int8: every stream equal to
   the colocated kernel engine's, K1 launched ``n_layer * chunk`` times
   per decode dispatch, no fallback), flat to paged and paged to flat
   (bf16 near-ties only), a torn payload (a counted fallback, the same stream),
   nano f32 handoffs on the card equal to the CPU's at T=0 and 0.8, with
   payload bytes per prompt token, the export and import pieces per
   request and decode-side TTFT/TPOT; then the lifecycle: an injected
   driver death, one ``supervise`` restart and a ``resume_from``
   stream equal to the uninterrupted one, ``supervise`` False after a
   second death, and ``drain`` of a busy engine (every stream equal to
   the colocated kernel engine's);
   then offline batch inference (``batch_infer_phase``,
   ``ray_tpu_torch.data.llm.BatchInferencer``): nano f32 rows through
   K1 on the card equal to the CPU's at T=0 and seeded 0.8; 128 GPT-2
   small rows (prompts of 16-512 tokens, two sharing a 250-token
   prefix, 32 new tokens at seeded T=0.8, blocks of 16, queue factor 2)
   on a K1 engine against a gather engine (bf16 near-ties only, taken
   with each lane's Gumbel noise), K1 on every decode step, no retry or
   restart, slot occupancy at least 0.8, the admission backlog within
   twice its bound, tok/s and peak memory; a run left after two blocks
   and resumed from its progress log on a fresh engine (the logged
   blocks admitted nothing, no row lost or repeated, the rest held to
   the uninterrupted run); a ``driver_die`` mid-run that costs one
   replay;
   then the observability plane (``observability_phase``): the port's
   flight recorder on a temporary directory through the 12-request K1
   serve (no torn record; ``engine.admit`` events equal the admissions,
   ``engine.dispatch`` events written plus dropped equal the dispatches;
   the port's ``serve_metrics()`` deltas of dispatches, kernel
   dispatches and tokens equal ``stats()``, the pages-free gauge the
   pool's, the dropped-events counter the recorder's drops; K1 launched
   ``n_layer * chunk`` times a dispatch), then the same serve with the
   recorder off and on, three pairs, tok/s of each;
   then the request batcher and trace spans (``batching_phase``): the 12
   requests from 12 caller threads through ``@batch(continuous=True)``
   on a K1 engine, tracing on (streams equal to the direct greedy K1
   streams, one ``engine.admission`` span a request under its
   ``request`` span, ``decode.chunk`` tokens adding up to each stream,
   K1 launched ``n_layer * chunk`` times a dispatch, no span dropped);
   ResNet-50 bf16 behind ``@batch(max_batch_size=16,
   pad_to_bucket=True)`` with 16 concurrent callers (bucket sizes only,
   logits against the unbatched forward, one ``batch.wait`` span a
   caller); the 12 requests at seeded T=0.8 through the same wrapper
   and one past its deadline (``RequestDeadlineExceeded``, counted once);
   then tensor-parallel decode: ``DecodeEngine(tp=2)`` on a gloo group
   of two ranks on this card (this process and a follower process),
   K1 over each rank's 6 heads held against its plain version (bf16
   and int8 pools) and launched ``n_layer * chunk`` times a dispatch on
   both ranks, 24 all-reduces a decode step, the 12 requests against
   the tp=1 K1 engines (bf16 near-ties, int8 and f32 budgets; first
   tokens may part at a near-tie too; the bf16 run with the recorder on
   in this process, rank 0, whose ``shard.dispatch`` events written plus
   dropped equal its ``engine.dispatch`` events), a tp=2 → tp=1 f32
   handoff whose
   every stream equals the colocated tp=1 engine's, TTFT/TPOT and one
   all-reduce's host ms (two
   ranks on one card: no figure for tensor parallelism across cards);
   then Mixture-of-Experts serving: nano with 4 experts (``init_params``
   on the card bit-equal to the CPU's; f32 streams through K1 equal to
   the CPU's on the CPU tests' drop-forcing pool, 14 requests for 12
   slots at capacity factor 0.25, at T=0 and T=0.8, and at 1.25); then
   GPT-2 small with 8 experts, top-2 (bf16, the reference's draw for
   seed 0, timed) serving the 12 requests through the same engine: every
   stream completes, K1 runs ``n_layer * chunk`` times per dispatch, the
   streams pass the MoE bf16 gate (``moe_gate``: every route and token
   decision K1 makes along the gather engine's replayed run is a
   rounding near-tie) and both injected K1 faults (``pos-1``,
   ``scale``) fail it; an int8 pool (count budget) and f32 (kernel vs
   gather within ``MAX_DIVERGED["f32"]``); an n-gram spec engine; a
   paged→paged fp handoff equal to the colocated kernel engine;
   TTFT/TPOT/tok/s beside the dense engine's; a profiled window with
   device time grouped into K1, GEMMs and routing kernels;
7. training: the flash and xla attention backends at full width (B=4,
   S=1024) from the same weights and batch (gradients and the loss
   after 2 steps within stated tolerances); nano at f32, 3 steps on the
   card through the kernels against 3 on the CPU through the plain
   versions; then GPT-2 small through ``make_train_step`` at bench.py's
   shape (B=32, S=1024, bf16, ``remat="dots"``, ``attn_backend="flash"``):
   3 warm-up and 10 timed steps, the loss finite and falling, the K2/K3
   launch counts equal to the derived count, tok/s, MFU, peak memory,
   and a profiled step's device busy share; then the same for the MoE
   model: flash vs xla at f32 compute (a bf16 rounding difference can
   flip a route), nano with 4 experts card vs CPU (losses and
   ``moe_aux``), and GPT-2 small with 8 experts at bench.py's shape
   (loss falling, ``moe_aux`` finite and positive, K2/K3 24/12/12 per
   step, MFU with its FLOP count written out);
8. sharded training (``parallel_train_phase``): two rank processes on
   this card over gloo run ``make_train_step`` over a mesh: 2 layers at
   f32 on {fsdp:2}, {tp:2}, {dp:2} against one rank on the card (losses
   within ``PAR_LOSS_RTOL``), 12 layers bf16 at bench.py's shape on
   {fsdp:2} and {tp:2} (loss falling, K2/K3 24/12/12 a step on each
   rank, tok/s, step ms and peak memory per rank, not a speed figure),
   a sharded checkpoint saved at {fsdp:2} and loaded at {tp:2}
   bit-equal; then K2/K3 at the ranks' shapes (B=16, H=6) against their
   plain versions, timed;
9. pipeline and expert parallelism (``pipeline_ep_phase``) on the same
   two ranks: 2 layers at f32 on {pp:2} at 2 and 4 microbatches, and
   with 8 experts (top-2, ``moe_aux_coef=1.0``, capacity factors 1.25
   and 0.5) on {ep:2} and {dp:2}, against one rank on the card (losses
   within ``PP_EP_LOSS_RTOL``); 12 layers bf16 at bench.py's shape on
   {pp:2} at 4 microbatches (K2/K3 48/24/24 a step on each stage) and
   {ep:2} with 8 experts (24/12/12 a step on each rank), the loss
   falling; a multislice step of two one-rank slices whose checksums
   agree; then K2/K3 at the microbatch shape (B=8, H=12) against their
   plain versions, timed;
10. ResNet (``resnet_phase``): ResNet-18 card vs CPU at f32, ResNet-50
    bf16 serving at batches 1-16 and one training step;
11. the RL numeric core (``rl_phase``, ``ray_tpu_torch.rllib``): every
    learner (PPO MLP and conv, DQN, SAC with and without CQL, BC,
    MARWIL) on the card against the CPU at f32, SAC's threefry draws
    bit-equal; PPO on a numpy CartPole (the reference's learning gate,
    then bench_rl.py's configuration to the solved stop: iterations,
    env steps/s, learner update ms); the Nature-CNN learner at 84x84x4
    (update ms, peak memory, against the CPU); two ``RankPool``
    learners on this card equal to two local learners averaged.

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
# logits. How many of the 12 bf16 streams part is a property of the
# weight draw (2 to 9 over 6 seeds of the reference's draw;
# benchmarks/torch_bf16_divergence.py), so no count of parted streams
# tells rounding from a small fault. A bf16 comparison holds each
# parting instead (``tie_ratios``): at the first step where two streams
# part, both tokens must lie within TIE_ERRS * eps of the top of the f32
# logits of their shared context (prompt and common tokens; the served
# weights in f32 arithmetic), where eps is the largest difference between
# a bf16 and that f32 forward's logits there, over all 50,304. A
# rounding parting's gap is the two engines' errors on the two tokens at
# stake, a fraction of that largest error: over 38 such partings (6
# draws) the largest gap was 0.68 eps, while a K1 that misses each
# slot's newest key parted a stream at 2.0-7.2 eps and one whose output
# is 3 % too large at 1.4-2.0 eps on every draw (PERF.md). So the bound
# is eps itself, and a stream that parts at a clear margin fails
# whatever the draw. This holds speculative engines too, whose verify
# step's batched GEMMs (16 slots x 5 positions) round differently from
# decode's (16 x 1).
# Budgets by count remain where that reference does not apply: every
# first token equal (prefill runs no kernel); at most three quarters of
# the int8 streams diverge (a rounding difference can also move a value
# across an int8 code boundary, which the f32 logits do not see); in
# f32, where the two paths differ by ~1e-6 and a flip needs a logit gap
# that small, at most one stream diverges, for fp and int8 pools alike.
TIE_ERRS = 1.0
MAX_DIVERGED = {"int8": 0.75, "f32": 1}

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
    the host; this leaves the host's gaps out. The profiler has come back
    empty, rarely, from a window of tiny kernels on the card (the greedy
    argmax below); such a window is profiled again, up to three times in
    all, and the log says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3
        log(f"device_ms: the profiler recorded no device time in window "
            f"{attempt + 1} of 3")
    raise RuntimeError("the profiler recorded no device time")


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


def k1_record(inp, name: str, label: str, card: str) -> dict:
    """K1 held against its plain version on every layer's pools of
    ``inp`` (fatal beyond ``KERNEL_TOL``) and timed beside it, SDPA over
    pre-gathered K/V (fp pools) and the card's bound: the kernels line's
    record, its launches still 0."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import paged_attention as pa

    err = max_err(pa.paged_attention_cuda, inp)
    log(f"K1 {label}: kernel vs plain max_abs_err={err:.6g} "
        f"(tolerance {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"K1 {label}: kernel disagrees with plain "
                             f"version: {err} > {KERNEL_TOL}")

    # Device time per call (the profiler's): a launch of K1 is shorter
    # than the host's cost of making one, so events around back-to-back
    # launches time the host (logged beside it as call_ms).
    args = inp.args
    ms = device_ms(lambda i: pa.paged_attention_cuda(*args(i)), 240)
    call_ms = cuda_ms(lambda i: pa.paged_attention_cuda(*args(i)), 240)
    plain_ms = device_ms(lambda i: pa.paged_attention_gather(*args(i)), 30)
    library_ms = None
    if inp.kv == "fp":
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
    rec = {"name": name, "route": "cuda", "source": SOURCE,
           "replaces": REPLACES, "launches": 0, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
           "bound_by": work["bound_by"], "library_ms": library_ms}
    log(f"K1 {label} timing [{card}] (B={inp.B} H={inp.H} hd={inp.hd}): "
        f"kernel_ms={ms:.6g} (device; {call_ms:.6g} a call back to back, "
        f"host included) plain_ms={plain_ms:.6g} library_ms={library_ms} "
        f"bound_ms={rec['bound_ms']:.6g} ({rec['bound_by']}: "
        f"{work['nbytes']} B, {work['flops']} flop) roofline_share="
        f"{rec['bound_ms'] / ms:.3f}")
    return rec


def kernel_phase(kv: str, card: str) -> dict:
    """K1 vs its plain version, then timings, at GPT-2-small decode shapes
    (``K1_SHAPES["small"]``, :func:`k1_record`); then held against the
    plain version and timed at the 1b skewed shape (on a log line; the
    record stays at the serving shape). Six layers' pools are cycled so
    each timed launch reads pages no earlier launch left in the 50 MB
    L2, as in the decode step."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    inp = decode_inputs("small", kv, seed=1 if kv == "fp" else 2)
    plan = pa._launch_plan(inp.max_pages, inp.ps, inp.hd,
                           inp.kc.element_size())
    clusters = pa._prepare(pa._load(), 1, kv == "int8", inp.hd, inp.ps,
                           inp.max_pages, plan, 0)
    log(f"K1 {kv} plan: {plan} -> grid ({plan.cluster}, {inp.H}, {inp.B}),"
        f" {inp.H * inp.B} clusters of {plan.cluster} blocks x 128 threads;"
        f" the card holds {clusters} clusters at once")
    rec = k1_record(inp, f"paged_attention_{'int8' if kv == 'int8' else 'bf16'}",
                    kv, card)
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
    records = _flash_time(qs, k, v, do, scale, errs, card)
    del qs, k, v, do
    torch.cuda.empty_cache()
    return records


def _flash_time(qs, k, v, do, scale, errs, card, suffix="") -> list:
    """K2, K3a, K3b timed on (qs, k, v, do) beside the plain versions,
    SDPA (a yardstick timed here only; the port never calls it) and the
    card's bound: one record per kernel, named with ``suffix``."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    B, S, H, hd = qs.shape
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
        rec = {"name": name + suffix, "route": "cuda",
               "source": FLASH_SOURCE,
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
    log(f"flash backward [{card}] (B={B} H={H}): K3a + K3b = "
        f"{ms['flash_attention_bwd_dkdv'] + ms['flash_attention_bwd_dq']:.6g}"
        f" ms (plus delta) against the plain backward {plain_bwd:.6g} ms and"
        f" SDPA's backward {lib_bwd:.6g} ms (both compute dq, dk, dv)")
    del o, lse, delta, qt, kt, vt, dot, qg, kg, vg
    torch.cuda.empty_cache()
    return records


def _train_batch(cfg, B, S, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(
        0, min(cfg.vocab_size, 50257), (B, S + 1))).to(device)}


def train_phase(card: str, n_experts: int = 0) -> dict:
    """GPT-2 small (with ``n_experts`` experts, top-2) trained through
    ``make_train_step`` at bench.py's shape with the flash kernels: 3
    warm-up steps, then 10 timed steps on one repeated batch, the counts
    set to 0 just before them; the loss finite and falling (an MoE
    model's ``moe_aux`` finite and above 0). Then one profiled step.
    Returns the launches counted in the timed steps."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt, moe
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(gpt.CONFIGS["small"], remat="dots",
                              attn_backend="flash", n_experts=n_experts)
    label = f"train small MoE ({n_experts} experts)" if n_experts else \
        "train small"
    init, step, _, _ = gpt.make_train_step(cfg, device="cuda")
    state = init(seed=0)
    batch = _train_batch(cfg, TRAIN_B, TRAIN_S, 5, "cuda")
    out = []
    for _ in range(3):
        state, m = step(state, batch)
        out.append(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    fa.launches.update(dict.fromkeys(fa.launches, 0))
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch)
        out.append(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in out]
    auxs = [float(m["moe_aux"]) for m in out if "moe_aux" in m]
    L, d, f, T = cfg.n_layer, cfg.d_model, cfg.d_ff, TRAIN_B * TRAIN_S
    # Per step: K2 once per layer in forward and once more per layer when
    # the remat policy recomputes the block (dots and full do: the flash
    # call is not a matrix product); K3a and K3b once per layer.
    recompute = gpt._remat_policy(cfg.remat) != "none"
    want = {"flash_attention_fwd": iters * L * (2 if recompute else 1),
            "flash_attention_bwd_dkdv": iters * L,
            "flash_attention_bwd_dq": iters * L}
    flops_tok = 6 * cfg.num_params() + 12 * L * TRAIN_S * d
    what = f"bench.py FLOPs/token {flops_tok}"
    flops = T * flops_tok
    if n_experts:
        # Forward + backward (3x the forward's products): bench.py's dense
        # count less the dense FFN, plus the router (d x E per token and
        # layer) and the experts at capacity (E x C rows of two d x f
        # products per layer, capacity padding included).
        E = n_experts
        C = moe.capacity(T, E, cfg.expert_top_k, cfg.capacity_factor)
        dense = flops_tok - 6 * L * 2 * d * f
        flops = T * (dense + 6 * L * d * E) + 6 * L * 2 * E * C * d * f
        what = (f"{flops:.6g} FLOPs a step = {T} tokens x ({dense} dense + "
                f"{6 * L * d * E} router) + experts 6 x {L} x 2 x {E} x {C} "
                f"x {d} x {f}; top-{cfg.expert_top_k}, capacity {C}")
    log(f"{label} bf16 [{card}] (B={TRAIN_B}, S={TRAIN_S}, remat=dots, "
        f"flash): {T * iters / dt:.1f} tok/s, step {dt / iters * 1e3:.3f} "
        f"ms, MFU {flops * iters / dt / BF16_FLOPS:.4f} ({what}, over "
        f"{BF16_FLOPS:g}), peak memory {peak / 2**30:.3f} GiB")
    log(f"{label} losses: {[round(x, 4) for x in losses]}"
        + (f"; moe_aux: {[round(x, 4) for x in auxs]}" if n_experts else ""))
    log(f"{label} launches in {iters} steps: {counts} (want {want}: "
        f"n_layer={L} x (2 if remat recomputes else 1) K2, n_layer each "
        f"K3a/K3b, per step)")
    if not all(map(math.isfinite, losses + auxs)):
        raise AssertionError(f"{label}: loss or moe_aux is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    if n_experts and not min(auxs) > 0:
        raise AssertionError(f"{label}: moe_aux is not positive: {auxs}")
    if counts != want:
        raise AssertionError(f"{label}: flash launches {counts} != {want}")
    profile_step(step, state, batch, card, label)
    del state
    torch.cuda.empty_cache()
    return counts


def profile_step(step, state, batch, card, label) -> None:
    """One profiled training step: device busy share, the top kernels and
    K2/K3's share of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms, rows = device_rows(prof)
    if busy_ms == 0:
        log(f"{label} profile: the profiler recorded no device time; "
            f"device busy share not measured")
        return
    log(f"{label} profile [{card}]: one step, device busy {busy_ms:.3f} "
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
    log(f"{label} profile: K2/K3 {sum(us for us, _ in flash) / 1e3:.3f} "
        f"ms of the step: " + "; ".join(text for _, text in flash))


def flash_vs_xla_phase(card: str, base=None) -> None:
    """The flash and xla attention backends on the card, full width,
    B=4, S=1024, the same weights and batch: per-parameter gradient error
    and the loss after 2 steps. ``base`` defaults to GPT-2 small in bf16;
    the MoE model runs at f32 (a bf16 rounding difference in attention
    can flip a route, which moves a whole token's FFN output; at f32 the
    two backends differ by about 1e-6 and a flip needs a router margin
    that small, so the bf16 tolerances hold with room)."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt

    base = base or gpt.CONFIGS["small"]
    moe = f" MoE {base.n_experts} experts" if base.n_experts else ""
    what = (f"small{moe}, B=4, S={TRAIN_S}, "
            f"{str(base.dtype).split('.')[-1]}")
    batch = _train_batch(base, 4, TRAIN_S, 6, "cuda")
    grads, loss2 = {}, {}
    for backend in ("flash", "xla"):
        cfg = dataclasses.replace(base, attn_backend=backend)
        init, step, _, _ = gpt.make_train_step(cfg, device="cuda")
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
    log(f"flash vs xla [{card}] ({what}): gradient "
        f"relative err max {errs[worst]:.4g} ({worst}; tolerance "
        f"{GRAD_TOL}); loss after 2 steps flash {loss2['flash']:.6f} xla "
        f"{loss2['xla']:.6f} |diff| {dl:.3g} (tolerance {LOSS2_TOL})")
    if errs[worst] > GRAD_TOL or not dl <= LOSS2_TOL:
        raise AssertionError("flash and xla training disagree beyond the "
                             "stated tolerance")
    del grads
    torch.cuda.empty_cache()


def nano_train_phase(n_experts: int = 0) -> None:
    """nano at f32 (with ``n_experts`` experts, top-2): 3 steps on the
    card through the kernels against 3 steps on the CPU through the plain
    versions, same weights and batch; losses (and ``moe_aux``) within
    ``NANO_TRAIN_TOL``."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.float32,
                              attn_backend="flash", n_experts=n_experts)
    weights = gpt.init_params(cfg, seed=0, device="cpu")
    losses = {}
    for device in ("cpu", "cuda"):
        init, step, _, _ = gpt.make_train_step(cfg, device=device)
        state = init(params=weights)
        batch = _train_batch(cfg, 8, 128, 7, device)
        before = dict(fa.launches)
        out = []
        for _ in range(3):
            state, m = step(state, batch)
            out.append(float(m["loss"]))
            if n_experts:
                out.append(float(m["moe_aux"]))
        losses[device] = out
        ran = {n: fa.launches[n] - before[n] for n in before}
        if device == "cuda" and not all(ran.values()):
            raise AssertionError(f"nano on the card skipped a kernel: {ran}")
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    what = f"nano MoE ({n_experts} experts)" if n_experts else "nano"
    log(f"{what} f32 training (losses{', moe_aux' if n_experts else ''}): "
        f"card+kernels {losses['cuda']} vs CPU+plain "
        f"{losses['cpu']}, max |diff| {diff:.3g} (tolerance "
        f"{NANO_TRAIN_TOL})")
    if not diff <= NANO_TRAIN_TOL:
        raise AssertionError(f"{what} f32 training: card and CPU disagree")


# Parallel training (slice 9): two ranks on this one card over gloo
# (NCCL refuses two ranks on one GPU). (a) f32 exactness at GPT-2-small
# width, 2 layers, against the one-rank port on the card: the ranks sum
# the same f32 products in another order (batch halves, tp partials), so
# losses agree to ~1e-7 relative. Parameters: the median within 1e-3 lr
# (tests/test_torch_train.py's bound); each one within 2 lr a step. Adam
# moves a weight by about lr a step whatever its gradient's size, so a
# gradient of ~1e-8 (an embedding row of a token the batch never holds:
# 50,304 rows, 2,048 tokens) whose sign flips with the summation order
# moves lr one way on one side and lr the other way on the other; PR 9's
# first chip run saw 1.02 lr on `embed` after 3 steps, medians 3.7e-9.
PAR_RANKS = 2
PAR_EXACT_MESHES = ({"fsdp": 2}, {"tp": 2}, {"dp": 2})
PAR_FULL_MESHES = ({"fsdp": 2}, {"tp": 2})
PAR_LOSS_RTOL = 1e-5
PAR_EXACT_B, PAR_EXACT_S = 8, 256


def _par_cfg(n_layer: int, dtype: str, cfg_kw=None):
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt

    return dataclasses.replace(gpt.CONFIGS["small"], n_layer=n_layer,
                               dtype=getattr(torch, dtype), remat="dots",
                               **{"attn_backend": "flash", **(cfg_kw or {})})


# Rank 0's one-rank references for the exactness checks, by name. They
# stay in the rank process on the card, so a check moves a few scalars
# to the controller, not the weights.
_REFERENCES: dict = {}


class _RouteLog:
    """Records an MoE model's routing during one step of a rank's run:
    the first ``n_layer`` calls of ``moe.route`` (the forward's layers
    in order; a remat recompute repeats them later in the step) as
    (expert ``[k, T]``, router probabilities ``[T, E]``, keep ``[k, T]``)
    on the host."""

    def __init__(self, n_layer: int):
        self.n_layer, self.calls = n_layer, []

    def __enter__(self):
        from ray_tpu_torch.models import moe

        self._real = real = moe.route

        def route(probs, *args, **kwargs):
            r = real(probs, *args, **kwargs)
            if len(self.calls) < self.n_layer:
                self.calls.append((r.expert.cpu(),
                                   probs.detach().float().cpu(),
                                   r.keep.cpu()))
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        from ray_tpu_torch.models import moe

        moe.route = self._real


def _step_logged(step, state, batch, n_layer, log_routes):
    """``step(state, batch)`` and, with ``log_routes``, its routes."""
    if not log_routes:
        return step(state, batch) + (None,)
    with _RouteLog(n_layer) as rec:
        state, m = step(state, batch)
    return state, m, rec.calls


def _rank_reference(name, cfg_kw=None, routes_at=None):
    """On rank 0 (the other rank idles): 3 f32 steps of the 2-layer model
    on one rank on the card (no mesh) from the seed-0 weights, at
    ``PAR_EXACT_B`` x ``PAR_EXACT_S``; keeps its parameters as
    ``_REFERENCES[name]`` and returns (losses, moe_aux terms, the routes
    of step ``routes_at`` (0-based) or ``None``)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt

    if dist.get_rank() != 0:
        return None
    _REFERENCES.clear()
    cfg = _par_cfg(2, "float32", cfg_kw)
    init, step, _, _ = gpt.make_train_step(cfg, device="cuda")
    state = init(seed=0)
    batch = _train_batch(cfg, PAR_EXACT_B, PAR_EXACT_S, 5, "cuda")
    losses, auxs, routes = [], [], None
    for i in range(3):
        state, m, got = _step_logged(step, state, batch, cfg.n_layer,
                                     i == routes_at)
        routes = got or routes
        losses.append(float(m["loss"]))
        auxs.append(float(m.get("moe_aux", 0.0)))
    _REFERENCES[name] = {k: v.detach() for k, v in state["params"].items()}
    del state
    torch.cuda.empty_cache()
    return losses, auxs, routes


def _rank_steps(axes, n_layer, dtype, B, S, warm, steps, reference=None,
                cfg_kw=None, routes_at=None):
    """On each rank of the pool: ``make_train_step`` over ``axes``, the
    seed-0 weights, ``warm`` steps, then ``steps`` steps timed with the
    flash counts zeroed just before; returns the losses (and an MoE
    model's ``moe_aux`` terms), this rank's launches, step ms, peak
    memory, its groups' op counts and (rank 0, with ``reference``) each
    gathered parameter's max and median |diff| from
    ``_REFERENCES[reference]``, and with ``routes_at`` the routes of that
    step (0-based; :class:`_RouteLog`). ``cfg_kw`` changes the config (a
    pipeline, an MoE model, sequence-parallel attention)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import create_mesh, gather_tree

    t_init = time.perf_counter()
    cfg = _par_cfg(n_layer, dtype, cfg_kw)
    mesh = create_mesh(axes)
    init, step, places, _ = gpt.make_train_step(cfg, mesh)
    state = init(seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    batch = _train_batch(cfg, B, S, 5, "cuda")
    losses, auxs, routes = [], [], None
    t_steps = time.perf_counter()
    for i in range(warm):
        state, m, got = _step_logged(step, state, batch, n_layer,
                                     i == routes_at)
        routes = got or routes
        losses.append(float(m["loss"]))
        auxs.append(float(m.get("moe_aux", 0.0)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches.update(dict.fromkeys(fa.launches, 0))
    t0 = time.perf_counter()
    for i in range(warm, warm + steps):
        state, m, got = _step_logged(step, state, batch, n_layer,
                                     i == routes_at)
        routes = got or routes
        losses.append(float(m["loss"]))
        auxs.append(float(m.get("moe_aux", 0.0)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {"losses": losses, "moe_aux": auxs, "launches": dict(fa.launches),
           "routes": routes,
           "step_ms": dt / steps * 1e3,
           "peak": torch.cuda.max_memory_allocated(),
           "ops": {"/".join(k): dict(g.stats)
                   for k, g in mesh._groups.items()}}
    t_gather = time.perf_counter()
    if reference:
        full = gather_tree(state["params"], places["params"])
        if dist.get_rank() == 0:
            ref = _REFERENCES[reference]
            diffs = {k: (full[k].detach().float() - ref[k].float()).abs()
                     for k in ref}
            out["param_diff"] = {k: (float(d.max()), float(d.median()))
                                 for k, d in diffs.items()}
            del diffs
        del full
    out["seconds"] = {"init": round(t_init, 3),
                      "steps": round(t_gather - t_steps, 3),
                      "gather": round(time.perf_counter() - t_gather, 3)}
    del state
    torch.cuda.empty_cache()
    return out


def _rank_reshard(path: str, save: bool):
    """(d): one f32 step at {fsdp: 2} saved as a sharded checkpoint
    (``save``; rank 0 keeps the gathered parameters), or the checkpoint
    loaded onto {tp: 2} over other weights; rank 0 returns how many
    gathered parameters are bit-equal to the saved ones, and of how
    many."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import create_mesh, gather_tree
    from ray_tpu_torch.train import Checkpoint

    cfg = _par_cfg(2, "float32")
    mesh = create_mesh({"fsdp": 2} if save else {"tp": 2})
    init, step, places, _ = gpt.make_train_step(cfg, mesh)
    state = init(seed=0 if save else 1)
    if save:
        state, _ = step(state, _train_batch(cfg, 4, 128, 9, "cuda"))
        Checkpoint.from_sharded_state(state["params"], path=path,
                                      placements=places["params"])
    else:
        state["params"] = Checkpoint(path).load_sharded_state(
            state["params"], placements=places["params"])
    full = gather_tree(state["params"], places["params"])
    out = None
    if dist.get_rank() == 0 and save:
        _REFERENCES["reshard"] = {k: v.detach() for k, v in full.items()}
    elif dist.get_rank() == 0:
        saved = _REFERENCES.pop("reshard")
        out = (sum(torch.equal(full[k], saved[k]) for k in saved),
               len(saved))
    del state
    torch.cuda.empty_cache()
    return out


def parallel_train_phase(card: str) -> list:
    """Sharded training at GPT-2-small width on two ranks sharing this
    card through gloo (this process is the controller; both ranks are
    processes of ``RankPool``). (a) 2 layers at f32, 3 steps at
    {fsdp:2}, {tp:2}, {dp:2} against the one-rank port on the card;
    (b) 12 layers, bf16, remat dots, flash, B=32, S=1024 at {fsdp:2}
    and {tp:2}: 1 + 3 steps, the loss falling, K2/K3 24/12/12 a step on
    EACH rank, tok/s, step ms and peak memory per rank (two ranks time-
    sharing one card, every collective staged through host memory by
    gloo: not a speed figure for sharded training across cards); (c) K2
    and K3 at the ranks' shapes (B=16 at fsdp:2, H=6 at tp:2) held
    against their plain versions and timed; (d) a sharded checkpoint
    saved at {fsdp:2} and loaded onto {tp:2}, the gathered parameters
    bit-equal. Returns the (c) records with (b)'s launches, summed over
    both ranks."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch._private.ranks import RankPool
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pool = RankPool(PAR_RANKS, devices=("cuda:0",) * PAR_RANKS,
                    backend="gloo")
    try:
        log(f"parallel: {PAR_RANKS} ranks on cuda:0 (gloo) started in "
            f"{time.perf_counter() - t0:.3f} s")
        # (a) exactness, f32, against one rank on the card
        ref = pool.run(_rank_reference, "dense")[0]
        for axes in PAR_EXACT_MESHES:
            res = pool.run(_rank_steps, axes, 2, "float32", PAR_EXACT_B,
                           PAR_EXACT_S, 0, 3, "dense")
            _hold_to_one(f"parallel (a) {axes} f32, 2 layers, B="
                         f"{PAR_EXACT_B} S={PAR_EXACT_S}", res, ref,
                         PAR_LOSS_RTOL)
        # (b) full depth, bf16, bench.py's shape
        counts = {}
        steps = 3
        L = gpt.CONFIGS["small"].n_layer
        want = {"flash_attention_fwd": 2 * L * steps,
                "flash_attention_bwd_dkdv": L * steps,
                "flash_attention_bwd_dq": L * steps}
        for axes in PAR_FULL_MESHES:
            res = pool.run(_rank_steps, axes, L, "bfloat16", TRAIN_B,
                           TRAIN_S, 1, steps)
            losses = res[0]["losses"]
            ms = max(r["step_ms"] for r in res)
            log(f"parallel (b) {axes} GPT-2 small bf16 [{card}] (B={TRAIN_B}"
                f", S={TRAIN_S}, remat=dots, flash; two ranks sharing ONE "
                f"card through gloo's host staging, not a speed figure for "
                f"sharded training): {TRAIN_B * TRAIN_S / ms * 1e3:.1f} "
                f"tok/s, step {ms:.3f} ms, peak memory per rank "
                f"{[round(r['peak'] / 2**30, 3) for r in res]} GiB; losses "
                f"{[round(x, 4) for x in losses]}; launches per rank in "
                f"{steps} steps {[r['launches'] for r in res]} (want {want})"
                f"; collectives on rank 0 in all {res[0]['ops']}")
            if not all(map(math.isfinite, losses)) or \
                    not losses[-1] < losses[0]:
                raise AssertionError(f"parallel (b) {axes}: loss not "
                                     f"finite and falling: {losses}")
            if any(r["launches"] != want for r in res):
                raise AssertionError(f"parallel (b) {axes}: flash launches "
                                     f"per rank {[r['launches'] for r in res]}"
                                     f" != {want}")
            counts[tuple(axes)] = {n: sum(r["launches"][n] for r in res)
                                   for n in want}
        # (d) resharding: fsdp:2 -> tp:2, bit-equal
        path = tempfile.mkdtemp(prefix="rt-torch-reshard-")
        try:
            pool.run(_rank_reshard, path, True)
            equal, n = pool.run(_rank_reshard, path, False)[0]
        finally:
            shutil.rmtree(path, ignore_errors=True)
        log(f"parallel (d) sharded checkpoint saved at {{fsdp: 2}}, loaded "
            f"onto {{tp: 2}}: gathered parameters bit-equal: {equal} of {n} "
            f"tensors")
        if equal != n:
            raise AssertionError("parallel (d): resharded parameters differ")
    finally:
        pool.close()
    # (c) K2/K3 at the ranks' shapes, in this process
    records = []
    for suffix, B, H, key in (("_b16", TRAIN_B // 2, 12, ("fsdp",)),
                              ("_h6", TRAIN_B, 6, ("tp",))):
        gen = torch.Generator(device="cuda").manual_seed(21)
        qs, k, v, do = (torch.randn(B, TRAIN_S, H, 64, device="cuda",
                                    generator=gen).to(torch.bfloat16)
                        for _ in range(4))
        qs = fa.scale_q(qs, 0.125)
        errs = _flash_hold(f"rank shape B={B} H={H}", qs, k, v, do, 0.125,
                           True)
        for rec in _flash_time(qs, k, v, do, 0.125, errs, card, suffix):
            base = rec["name"][:-len(suffix)]
            rec["launches"] = counts[key][base]
            records.append(rec)
        del qs, k, v, do
        torch.cuda.empty_cache()
    return records


# Pipeline and expert parallelism (slice 10), two ranks on this card over
# gloo as in parallel_train_phase. (a) f32 exactness at GPT-2-small width
# with 2 layers: a pipeline step sums the same f32 products per
# microbatch; an MoE step on {ep:2} computes every row as one rank does
# and sums two experts' gated outputs, exact in f32; on {dp:2} each rank
# routes its half of the batch against the GLOBAL capacity and slot
# order, which only a changed route would break (a flipped route moves
# the loss by far more than 1e-6 relative). Parameters within PR 9's
# bound (2 lr a step, medians 1e-3 lr).
PP_EP_LOSS_RTOL = 1e-6
# moe_aux after the first step: the weights of the two runs differ by
# AdamW's moves on near-zero gradients whose f32 sums run in another
# order (see the parameter bound above). Counted on the card: at step 2
# no route differs from one rank's, in expert or in kept/dropped, on
# {dp:2}, {tp:2}, ring {sp:2} or {ep:2}, at capacity factor 1.25 or 0.5;
# yet moe_aux parts by up to 2.43e-6 relative at 0.5 ({ep:2}, whose sums
# run in one rank's order, by 0), so the drift is the weights', not a
# flipped route: 1e-6 would fail, 1e-5 holds it with room.
MOE_AUX_DRIFT_RTOL = 1e-5
PP_EXACT_MICROBATCHES = (2, 4)
MOE_EXACT_MESHES = ({"ep": 2}, {"dp": 2})
MOE_EXACT_FACTORS = (1.25, 0.5)
PP_FULL_MICROBATCHES = 4
# MoE with tensor and sequence parallelism, on the same two
# ranks: {tp:2} (each rank d_ff/2 of every expert, the down product's f32
# partials summed before the cast) and ring {sp:2} (each rank a sequence
# chunk of every row, slots in the global row-major token order), held
# to one rank at f32 within PAR_LOSS_RTOL; {tp:2} at full depth.
MOE_TP_SP_MESHES = (({"tp": 2}, {}),
                    ({"sp": 2}, {"attn_backend": "ring", "sp_axis": "sp"}))
MOE_ROUTES_AT = 1                  # step 2: the first after an update
# Full-depth MoE {tp:2}: both ranks hold every row, so each would keep
# B=32's f32 logits, their log-softmax and its gradient (6.1 GiB each)
# beside ~25 GiB of weights and activations; two such ranks overflow
# the one card they share (chip run 2: out of memory). The reference's
# chunked cross-entropy (cfg.loss_chunk, the same loss) keeps one
# 256-position chunk of logits live.
MOE_TP_LOSS_CHUNK = 256


def _route_flips(axes, one, res) -> dict:
    """How many (choice, token) routes of the logged step differ between
    one rank (``one``: :class:`_RouteLog` calls) and the mesh's ranks
    (reassembled into the global token order: rows over dp, sequence
    chunks over sp, whole on the other axes): their expert (``flips``),
    and whether the pair is kept or dropped (``drops``, the global
    slots' test); and the smallest and largest gap, in one rank's router
    probabilities, between the two experts of a flipped route."""
    import torch

    def whole(parts, k):
        if "dp" in axes:
            return torch.cat(parts, 1), 0
        if "sp" in axes:
            return torch.cat([p.view(k, PAR_EXACT_B, -1) for p in parts],
                             2).reshape(k, -1), 0
        return parts[0], sum(int((p != parts[0]).sum()) for p in parts[1:])

    flips, drops, gaps, pairs = 0, 0, [], 0
    for layer, (want, probs, kept) in enumerate(one):
        k = want.shape[0]
        got, apart = whole([r["routes"][layer][0] for r in res], k)
        got_kept, apart_kept = whole([r["routes"][layer][2] for r in res],
                                     k)
        diff = got != want
        flips += int(diff.sum()) + apart      # tp/ep ranks must agree too
        drops += int((got_kept != kept).sum()) + apart_kept
        pairs += want.numel()
        if diff.any():
            j, t = diff.nonzero(as_tuple=True)
            gaps += (probs[t, want[j, t]] - probs[t, got[j, t]]).abs(
            ).tolist()
    return {"flips": flips, "drops": drops, "of": pairs,
            "gap": (min(gaps), max(gaps)) if gaps else None}


def _hold_to_one(label, res, ref, loss_rtol, moe=False, flash=True,
                 axes=None) -> None:
    """(a): every rank's losses (and the first step's ``moe_aux``) within
    ``loss_rtol`` relative of one rank's on the card (``ref``: losses,
    moe_aux terms, routes, from :func:`_rank_reference`), later
    ``moe_aux`` terms within ``MOE_AUX_DRIFT_RTOL``, every gathered
    parameter within 2 lr a step and its median within 1e-3 lr (rank 0's
    ``param_diff``), and (``flash``) every flash kernel launched on every
    rank. With routes logged on both sides, prints how many routes of
    that step differ from one rank's on the mesh ``axes``."""
    from ray_tpu_torch.models import gpt

    lr = gpt.ADAMW_DEFAULTS["lr"]
    ref_losses, ref_auxs, ref_routes = ref
    rel = max(abs(a - b) / abs(b) for r in res
              for a, b in zip(r["losses"], ref_losses))
    drift = 0.0
    if moe:
        rel = max([rel] + [abs(r["moe_aux"][0] - ref_auxs[0]) /
                           abs(ref_auxs[0]) for r in res])
        drift = max(abs(a - b) / abs(b) for r in res
                    for a, b in zip(r["moe_aux"], ref_auxs))
    diffs = res[0]["param_diff"]
    worst = max(diffs, key=lambda k: diffs[k][0])
    med = max(m for _, m in diffs.values())
    log(f"{label}: losses {res[0]['losses']} vs one rank {ref_losses}"
        + (f", moe_aux {res[0]['moe_aux']} vs {ref_auxs}" if moe else "") +
        f"; max relative diff {rel:.3g} (tolerance {loss_rtol}"
        + (f"; later moe_aux {drift:.3g}, tolerance {MOE_AUX_DRIFT_RTOL}"
           if moe else "") +
        f"); params max |diff| {diffs[worst][0]:.3g} ({worst}; tolerance 2 "
        f"lr a step = {2 * 3 * lr:.3g}), largest median {med:.3g} "
        f"(tolerance {1e-3 * lr:.3g}); K2/K3 launches per rank "
        f"{[r['launches'] for r in res]}; rank 0's seconds "
        f"{res[0]['seconds']}")
    if ref_routes and res[0]["routes"]:
        flips = _route_flips(axes, ref_routes, res)
        log(f"{label}: routes at step {MOE_ROUTES_AT + 1} differing from "
            f"one rank's: expert {flips['flips']}, kept/dropped "
            f"{flips['drops']}, of {flips['of']} (choice, token) pairs "
            f"over the layers; smallest/largest probability gap between "
            f"the two experts of a differing route: {flips['gap']}")
    if not rel <= loss_rtol or not drift <= MOE_AUX_DRIFT_RTOL \
            or diffs[worst][0] > 2 * 3 * lr or med > 1e-3 * lr:
        raise AssertionError(f"{label}: the f32 step disagrees with one "
                             f"rank")
    if flash and not all(all(r["launches"].values()) for r in res):
        raise AssertionError(f"{label}: a rank skipped a flash kernel")


def pipeline_ep_phase(card: str) -> list:
    """Pipeline and expert parallelism on two ranks sharing this card
    through gloo (``RankPool``, as ``parallel_train_phase``). (a) f32, 2
    layers, GPT-2-small width, B=8, S=256, 3 steps against one rank on
    the card: {pp:2} at 2 and 4 microbatches; 8 experts, top-2,
    ``moe_aux_coef=1.0`` at capacity factors 1.25 and 0.5 on {ep:2} and
    {dp:2} (the global-capacity case). (b) GPT-2 small, 12 layers, bf16,
    remat dots, flash, B=32, S=1024, one warm step and 3 more: {pp:2} at
    4 microbatches (K2/K3 48/24/24 a step on EACH stage: 6 layers x 4
    microbatches, forward and remat recompute) and {ep:2} with 8 experts
    (24/12/12 a step on each rank: every ep rank runs every layer on the
    whole batch); the loss falling, step ms, tok/s and peak memory per
    rank (two ranks time-sharing one card: no speed figure for
    pipelining). (d) multislice: two slices of one rank each, every
    slice's checksum equal. Then (c) K2/K3 at the microbatch shape
    (B=8, H=12) held against their plain versions and timed; returns
    their records with (b)'s {pp:2} launches summed over both ranks."""
    import torch

    from ray_tpu_torch._private.ranks import RankPool
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.multislice import slice_rank

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pool = RankPool(PAR_RANKS, devices=("cuda:0",) * PAR_RANKS,
                    backend="gloo")
    try:
        log(f"pipeline/ep: {PAR_RANKS} ranks on cuda:0 (gloo) started in "
            f"{time.perf_counter() - t0:.3f} s")
        # (b) full depth, bf16, bench.py's shape (first: a fault at full
        # width shows before the exactness cases' minutes)
        steps, L = 3, gpt.CONFIGS["small"].n_layer
        M = PP_FULL_MICROBATCHES
        full = (({"pp": 2}, {"pp_axis": "pp", "num_microbatches": M},
                 {"flash_attention_fwd": 2 * L // 2 * M * steps,
                  "flash_attention_bwd_dkdv": L // 2 * M * steps,
                  "flash_attention_bwd_dq": L // 2 * M * steps}),
                ({"ep": 2}, {"n_experts": MOE_EXPERTS},
                 {"flash_attention_fwd": 2 * L * steps,
                  "flash_attention_bwd_dkdv": L * steps,
                  "flash_attention_bwd_dq": L * steps}),
                ({"tp": 2}, {"n_experts": MOE_EXPERTS,
                             "loss_chunk": MOE_TP_LOSS_CHUNK},
                 {"flash_attention_fwd": 2 * L * steps,
                  "flash_attention_bwd_dkdv": L * steps,
                  "flash_attention_bwd_dq": L * steps}))
        counts = {}
        for axes, kw, want in full:
            res = pool.run(_rank_steps, axes, L, "bfloat16", TRAIN_B,
                           TRAIN_S, 1, steps, None, kw)
            losses = res[0]["losses"]
            ms = max(r["step_ms"] for r in res)
            log(f"pipeline/ep (b) {axes} {kw} GPT-2 small bf16 [{card}] ["
                f"{time.perf_counter() - t0:.1f} s into the phase] "
                f"(B={TRAIN_B}, S={TRAIN_S}, remat=dots, flash; two ranks "
                f"sharing ONE card through gloo's host staging, not a speed "
                f"figure): {TRAIN_B * TRAIN_S / ms * 1e3:.1f} tok/s, step "
                f"{ms:.3f} ms, peak memory per rank "
                f"{[round(r['peak'] / 2**30, 3) for r in res]} GiB; losses "
                f"{[round(x, 4) for x in losses]}"
                + (f", moe_aux {[round(x, 4) for x in res[0]['moe_aux']]}"
                   if "n_experts" in kw else "") +
                f"; K2/K3 launches per rank in {steps} steps "
                f"{[r['launches'] for r in res]} (predicted {want} on each "
                f"rank); collectives on rank 0 in all {res[0]['ops']}; rank "
                f"0's seconds {res[0]['seconds']}")
            if not all(map(math.isfinite, losses)) or \
                    not losses[-1] < losses[0]:
                raise AssertionError(f"pipeline/ep (b) {axes}: loss not "
                                     f"finite and falling: {losses}")
            if "n_experts" in kw and not all(
                    math.isfinite(a) and a > 0 for a in res[0]["moe_aux"]):
                raise AssertionError(f"pipeline/ep (b) {axes}: moe_aux "
                                     f"{res[0]['moe_aux']}")
            if any(r["launches"] != want for r in res):
                raise AssertionError(f"pipeline/ep (b) {axes}: flash "
                                     f"launches per rank "
                                     f"{[r['launches'] for r in res]} != "
                                     f"{want}")
            counts[tuple(axes)] = {n: sum(r["launches"][n] for r in res)
                                   for n in want}
            if "n_experts" in kw:
                per_step = [{n: c / steps for n, c in r["launches"].items()}
                            for r in res]
                log(f"pipeline/ep (b) {axes} MoE: K2/K3 launches a step on "
                    f"each rank {per_step}, tok/s "
                    f"{TRAIN_B * TRAIN_S / ms * 1e3:.1f}, step {ms:.3f} ms, "
                    f"peak GiB per rank "
                    f"{[round(r['peak'] / 2**30, 3) for r in res]} [{card}]")
        # (a) exactness, f32, against one rank on the card
        ref = pool.run(_rank_reference, "dense")[0]
        for m in PP_EXACT_MICROBATCHES:
            kw = {"pp_axis": "pp", "num_microbatches": m}
            res = pool.run(_rank_steps, {"pp": 2}, 2, "float32",
                           PAR_EXACT_B, PAR_EXACT_S, 0, 3, "dense", kw)
            at = time.perf_counter() - t0
            _hold_to_one(f"pipeline/ep (a) {{pp: 2}} M={m} f32, 2 layers, "
                         f"B={PAR_EXACT_B} S={PAR_EXACT_S} [{at:.1f} s into "
                         f"the phase]", res, ref, PP_EP_LOSS_RTOL)
        for cf in MOE_EXACT_FACTORS:
            kw = {"n_experts": MOE_EXPERTS, "capacity_factor": cf,
                  "moe_aux_coef": 1.0}
            ref = pool.run(_rank_reference, f"moe{cf}", kw,
                           MOE_ROUTES_AT)[0]
            for axes in MOE_EXACT_MESHES:
                res = pool.run(_rank_steps, axes, 2, "float32", PAR_EXACT_B,
                               PAR_EXACT_S, 0, 3, f"moe{cf}", kw,
                               MOE_ROUTES_AT)
                _hold_to_one(f"pipeline/ep (a) {axes} MoE {MOE_EXPERTS} "
                             f"experts top-2 capacity factor {cf} f32, 2 "
                             f"layers [{time.perf_counter() - t0:.1f} s into "
                             f"the phase]", res, ref, PP_EP_LOSS_RTOL,
                             moe=True, axes=axes)
            # MoE x tp and MoE x sp: the global token order
            for axes, extra in MOE_TP_SP_MESHES:
                res = pool.run(_rank_steps, axes, 2, "float32", PAR_EXACT_B,
                               PAR_EXACT_S, 0, 3, f"moe{cf}",
                               {**kw, **extra}, MOE_ROUTES_AT)
                at = time.perf_counter() - t0
                _hold_to_one(f"pipeline/ep (a) {axes} {extra} MoE "
                             f"{MOE_EXPERTS} experts top-2 capacity factor "
                             f"{cf} f32, 2 layers [{at:.1f} s into the "
                             f"phase]", res, ref, PAR_LOSS_RTOL, moe=True,
                             axes=axes, flash="sp" not in axes)
        # (d) multislice: two slices of one rank each
        reports = pool.run(slice_rank, 2, 1, "cuda:0")
        log(f"pipeline/ep (d) [{time.perf_counter() - t0:.1f} s into the "
            f"phase] multislice, 2 slices x 1 rank on cuda:0 "
            f"(nano, one SGD step, gradients averaged across slices over "
            f"gloo on host tensors): {reports}")
        if not all(r["agree"] for r in reports) or \
                len({r["checksum"] for r in reports}) != 1:
            raise AssertionError(f"multislice: checksums differ: {reports}")
    finally:
        pool.close()
    # (c) K2/K3 at the pipeline's microbatch shape, in this process
    B = TRAIN_B // PP_FULL_MICROBATCHES
    gen = torch.Generator(device="cuda").manual_seed(22)
    qs, k, v, do = (torch.randn(B, TRAIN_S, 12, 64, device="cuda",
                                generator=gen).to(torch.bfloat16)
                    for _ in range(4))
    qs = fa.scale_q(qs, 0.125)
    errs = _flash_hold(f"microbatch shape B={B}", qs, k, v, do, 0.125, True)
    records = []
    for rec in _flash_time(qs, k, v, do, 0.125, errs, card, f"_b{B}"):
        rec["launches"] = counts[("pp",)][rec["name"][:-len(f"_b{B}")]]
        records.append(rec)
    del qs, k, v, do
    torch.cuda.empty_cache()
    return records


# ResNet. No TPU kernel is on this path: the reference's
# convolutions are lax.conv_general_dilated, the port's cuDNN's.
# (i) ResNet-18 at width 16 on 64x64 images, f32 with TF32 off inside the
# comparison only, card vs CPU: |logits| < ~3 and the two sum each conv
# in another order (the CPU tests measure 2e-6 against the reference);
# the batch-norm statistics are f32 means of up to 2^15 terms a channel.
RESNET_TINY = dict(depth=18, num_classes=10, width=16)
RESNET_LOGIT_ATOL = 1e-4
RESNET_STAT_RTOL, RESNET_STAT_ATOL = 1e-4, 1e-5
# (ii) ResNet-50 at full width (1000 classes, bf16, the seed-0 draw) on
# 224x224 NHWC images through make_predictor at the serving buckets
# (the reference's serve/batching.default_buckets(16)), float and uint8
# images; the bf16 logits held against an f32 run of the same weights on
# the card: each bf16 rounding of ~50 conv/BN outputs is 2^-9 relative,
# so the logits may part by a few percent of their range; bound 5 %.
RESNET_BUCKETS = (1, 2, 4, 8, 16)
RESNET_BF16_REL = 0.05
RESNET_TRAIN_B = 32


def resnet_phase(card: str) -> None:
    """ResNet (``ray_tpu_torch.models.resnet``): (i) ResNet-18 width 16
    at f32, ``train=False`` and ``train=True`` logits and every updated
    running statistic, card (TF32 off) against the CPU; (ii) ResNet-50
    at full width, bf16: p50 ms a batch (host images in, logits out,
    synchronised) at each bucket for float and uint8 images, images/s at
    16, the bf16 logits against an f32 run on the card, and one
    ``train=True`` forward + backward at B=32 with finite gradients (ms,
    peak memory). No TPU kernel runs here: cuDNN convolutions."""
    import dataclasses

    import numpy as np
    import torch

    from ray_tpu_torch.models import resnet

    t0 = time.perf_counter()
    tiny = resnet.ResNetConfig(**RESNET_TINY, dtype=torch.float32)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 64, 64, 3)).astype(
        np.float32) * 2 + 0.5)
    out = {}
    for dev in ("cpu", "cuda"):
        params = resnet.init_params(tiny, 0, device=dev)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            with torch.no_grad():
                logits = resnet.forward(params, x.to(dev), tiny)
                tl, new = resnet.forward(params, x.to(dev), tiny, train=True)
        out[dev] = (logits.cpu(), tl.cpu(), [t.cpu() for t in
                                             resnet.leaves(new)],
                    [t.cpu() for t in resnet.leaves(params)])
    (inf_c, train_c, new_c, p_c), (inf_g, train_g, new_g, p_g) = \
        out["cpu"], out["cuda"]
    if not all(torch.equal(a, b) for a, b in zip(p_c, p_g)):
        raise AssertionError("resnet (i): the card's init_params differ "
                             "from the CPU's")
    err = max(_abs_err(inf_g, inf_c), _abs_err(train_g, train_c))
    stat = max(float(((a - b).abs() - RESNET_STAT_RTOL * b.abs()).max())
               for a, b in zip(new_g, new_c))
    log(f"resnet (i) ResNet-18 width 16, 64x64, f32 [{card}]: init_params "
        f"on the card bit-equal to the CPU's; logits (train False/True) "
        f"card (TF32 off) vs CPU max |diff| {err:.3g} (tolerance "
        f"{RESNET_LOGIT_ATOL}); running statistics: largest |diff| beyond "
        f"{RESNET_STAT_RTOL} relative {stat:.3g} (tolerance "
        f"{RESNET_STAT_ATOL}); no TPU kernel on this path (cuDNN convs)")
    if not err <= RESNET_LOGIT_ATOL or not stat <= RESNET_STAT_ATOL:
        raise AssertionError("resnet (i): the card disagrees with the CPU")

    # (ii) ResNet-50 at full width
    cfg = resnet.ResNetConfig(depth=50)
    torch.cuda.synchronize()
    t_init = time.perf_counter()
    params = resnet.init_params(cfg, 0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    imgs = rng.standard_normal((max(RESNET_BUCKETS), 224, 224, 3)).astype(
        np.float32)
    u8 = rng.integers(0, 256, imgs.shape, dtype=np.uint8)
    times = {}
    for kind, src in (("float", imgs), ("uint8", u8)):
        predict = resnet.make_predictor(cfg, params,
                                        uint8_input=kind == "uint8")
        for b in RESNET_BUCKETS:
            batch = src[:b]
            for _ in range(3):
                predict(batch).cpu()
            ms = []
            for _ in range(20):
                t = time.perf_counter()
                got = predict(batch).cpu()
                ms.append((time.perf_counter() - t) * 1e3)
            if got.shape != (b, cfg.num_classes) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(f"resnet (ii) {kind} B={b}: logits "
                                     f"{tuple(got.shape)}, not all finite")
            times[(kind, b)] = p50(ms)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = resnet.make_predictor(f32, params)(imgs).cpu()
    got = resnet.make_predictor(cfg, params)(imgs).cpu()
    rel = _abs_err(got, want) / float(want.abs().max())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    # one train=True forward + backward at B=32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    leaves = resnet.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    xb = torch.from_numpy(rng.standard_normal(
        (RESNET_TRAIN_B, 224, 224, 3)).astype(np.float32)).cuda()
    train_ms = []
    for _ in range(3):
        for t in leaves:
            t.grad = None
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = resnet.forward(params, xb, cfg, train=True)
        ((logits - 1.0) ** 2).mean().backward()
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(t.grad).all()) for t in leaves
                 if t.grad is not None)
    n_grads = sum(t.grad is not None for t in leaves)
    log(f"resnet (ii) ResNet-50 full width ({cfg.num_params()} params, "
        f"{cfg.num_classes} classes, bf16, 224x224 NHWC, seed-0 weights "
        f"drawn on the "
        f"card in {t_init:.3f} s) [{card}]: p50 ms a batch (host images "
        f"in, logits on the host, 20 calls after 3) float "
        f"{ {b: round(times[('float', b)], 3) for b in RESNET_BUCKETS} }, "
        f"uint8 { {b: round(times[('uint8', b)], 3) for b in RESNET_BUCKETS} }"
        f"; images/s at 16: float "
        f"{16e3 / times[('float', 16)]:.1f}, uint8 "
        f"{16e3 / times[('uint8', 16)]:.1f}; bf16 logits vs f32 (TF32 off) "
        f"max |diff| / max |f32| = {rel:.4g} (tolerance {RESNET_BF16_REL}),"
        f" top-1 agreement {top1:.3f}; train=True forward+backward B="
        f"{RESNET_TRAIN_B}: ms {[round(m, 3) for m in train_ms]}, peak "
        f"{peak / 2**30:.3f} GiB, {n_grads} gradients all finite: {finite}"
        f"; no TPU kernel on this path (cuDNN convs, channels-last "
        f"activations) [{time.perf_counter() - t0:.1f} s in the phase]")
    if not rel <= RESNET_BF16_REL or not finite or n_grads == 0:
        raise AssertionError("resnet (ii): bf16 logits or gradients wrong")
    del params, leaves, xb
    torch.cuda.empty_cache()


# ---- RL: the rllib numeric core's learners on the card
# Card vs CPU at f32 (TF32 off in every learner step), from the same
# numpy weights and batches: every metric within RL_TOL of the CPU's,
# relative to max(|value|, 1); every parameter, target and Adam moment
# within RL_TOL of the CPU's, relative to max(its leaf's largest
# magnitude, 1e-3). On the CPU the port's learners sit within ~2e-6 of
# the reference's by these measures (tests/test_torch_rllib*.py).
RL_TOL = 1e-5
# Conv learners are held otherwise: their ReLUs are kinks. An input
# within rounding of 0 (a Nature-CNN minibatch of 128 has 2.8M) can be
# on in one computation and off in the other, and its term then enters
# a conv weight's gradient in one only: ~1e-3 of the leaf's largest
# gradient. Adam's moments carry that (held within RL_CONV_TOL), and its
# step is ~±lr for any gradient above eps, so a gradient near 0 can step
# the other way: at most RL_FLIPS of the parameters may part by more
# than RL_TOL. The CPU's own f32 update held to an f64 run passes the
# same hold, kink included (tests/test_torch_rllib.py::
# test_chip_smoke_hold_covers_f32_rounding: moments 9.3e-4, 36 of 1.69M
# parameters at seed 12).
RL_CONV_TOL = 5e-3
RL_FLIPS = 1e-4
# (b) benchmarks/bench_rl.py's PPO CartPole configuration and its solved
# stop (mean return >= 450 over >= 20 episodes), at most RL_MAX_ITERS
# iterations. The learning gate is the reference's test
# (tests/test_rllib.py:58), run at that test's own configuration
# (:9-19): a best mean return of at least 120 within 25 iterations of
# 1,024 env steps. bench_rl.py's iterations are half as long, and there
# both packages reach 109.75 in 25 (seed 0, the CPU).
RL_PPO = dict(lr=3e-4, train_batch_size=512, minibatch_size=128,
              num_epochs=8, entropy_coeff=0.01)
RL_ENVS, RL_FRAGMENT, RL_HIDDEN = 8, 64, (64, 64)
RL_SOLVED, RL_MAX_ITERS = 450.0, 150
RL_GATE = dict(lr=3e-4, train_batch_size=1024, minibatch_size=256,
               num_epochs=6, entropy_coeff=0.001)
RL_GATE_FRAGMENT, RL_GATE_ITERS, RL_GATE_RETURN = 32, 25, 120.0
# (c) the Nature-CNN torso at Atari's shape (bench_rl.py's IMPALA
# pipeline: 84x84x4 frames, 6 actions; torso 512) at minibatch 128.
RL_ATARI = dict(obs_shape=(84, 84, 4), num_actions=6, torso=512, batch=128)
# (e) multi-agent PPO: the reference's learning gate at its test's
# configuration (tests/test_rllib_multi_agent.py:283-313): the best joint
# return of CooperativeCorridor reaches RL_MA_RETURN within RL_MA_ITERS
# iterations (random play scores about -1.3, the best about 3.3).
RL_MA = dict(train_batch_size=2048, minibatch_size=256, num_epochs=6,
             lr=3e-4, entropy_coeff=0.01)
RL_MA_ENVS, RL_MA_FRAGMENT, RL_MA_HIDDEN = 4, 128, (32, 32)
RL_MA_ITERS, RL_MA_RETURN = 40, 2.0
# (f) DreamerV3 at the reference's XS size (the default DreamerV3Config:
# deter 256, units 256, 8x8 latents, horizon 15, seq_len 16, 8 sequences)
# on the numpy CartPole: RL_DV3_ITERS iterations of the algorithm (the
# first four fill the replay, then 8 updates each). One update is held
# card vs CPU from the same state, batch and key: the keys bit-equal,
# the Gumbel noise within GUMBEL_ULPS, the samples compared index for
# index (a latent or action whose two best perturbed logits lie within
# the noise's rounding flips; flips are counted, not hidden); then the
# CPU update is rerun on the card's noise, so every sample is the same
# draw, and its metrics, Adam moments and slow critic must lie within
# RL_TOL of the card's, and at most RL_FLIPS of its parameters outside
# the actor beyond it (Adam steps a near-zero gradient by ~±lr either
# way). The actor's parameters are counted, not held: while the reward
# and critic heads still predict ~0 (they start at zero), the returns
# and advantages that drive the actor are the rounding noise of their
# 255-bin sums, which the card and the CPU sum in other orders, and
# Adam turns each noise-driven gradient into a ±lr step
# (tests/test_torch_rllib_dreamer.py shows the same against the
# reference).
RL_DV3_ITERS = 7
# (g) IMPALA at benchmarks/bench_rl.py's Pong-shaped configuration
# (:60-121): 2 Nature-CNN runners x 2 envs on a synthetic 84x84x4 env of
# 6 actions, fragments of 32, one aggregator, train batch 256, lr 3e-4,
# 8 iterations; then the reference's APPO smoke (tests/
# test_rllib_depth.py:112-128) on the numpy CartPole.
RL_IMPALA_ITERS = 8
RL_APPO_ITERS = 3




def make_cartpole():
    """CartPole-v1 in numpy, with gymnasium's dynamics, reset draw and
    TimeLimit (truncation at 500 steps), for machines without gymnasium;
    ``tests/test_torch_rllib.py`` holds it to ``gymnasium.make(
    "CartPole-v1")`` step for step."""
    import types

    import numpy as np

    class CartPole:
        observation_space = types.SimpleNamespace(shape=(4,))
        action_space = types.SimpleNamespace(n=2)
        gravity, masscart, masspole, length = 9.8, 1.0, 0.1, 0.5
        force_mag, tau, max_steps = 10.0, 0.02, 500
        total_mass = masspole + masscart
        polemass_length = masspole * length
        theta_threshold = 12 * 2 * math.pi / 360
        x_threshold = 2.4

        def __init__(self):
            self.rng = None
            self.state = None
            self.steps = 0

        def reset(self, *, seed=None, options=None):
            if seed is not None or self.rng is None:
                self.rng = np.random.default_rng(seed)
            self.state = self.rng.uniform(low=-0.05, high=0.05, size=(4,))
            self.steps = 0
            return np.array(self.state, dtype=np.float32), {}

        def step(self, action):
            x, x_dot, theta, theta_dot = self.state
            force = self.force_mag if action == 1 else -self.force_mag
            costheta, sintheta = np.cos(theta), np.sin(theta)
            temp = (force + self.polemass_length * np.square(theta_dot)
                    * sintheta) / self.total_mass
            thetaacc = (self.gravity * sintheta - costheta * temp) / (
                self.length * (4.0 / 3.0 - self.masspole
                               * np.square(costheta) / self.total_mass))
            xacc = temp - self.polemass_length * thetaacc * costheta \
                / self.total_mass
            x = x + self.tau * x_dot
            x_dot = x_dot + self.tau * xacc
            theta = theta + self.tau * theta_dot
            theta_dot = theta_dot + self.tau * thetaacc
            self.state = np.array((x, x_dot, theta, theta_dot),
                                  dtype=np.float64)
            terminated = bool(x < -self.x_threshold or x > self.x_threshold
                              or theta < -self.theta_threshold
                              or theta > self.theta_threshold)
            self.steps += 1
            return (np.array(self.state, dtype=np.float32), 1.0, terminated,
                    self.steps >= self.max_steps, {})

    return CartPole()


def make_corridor():
    """The reference's two-policy CooperativeCorridor
    (tests/test_rllib_multi_agent.py:108-156): agent "left" must reach
    cell 4 and "right" cell 0 of a 5-cell corridor; dense progress
    shaping, a joint completion bonus, 40-step truncation."""
    import types

    import numpy as np

    class CooperativeCorridor:
        L = 5
        possible_agents = ["left", "right"]
        observation_spaces = {a: types.SimpleNamespace(shape=(2,))
                              for a in possible_agents}
        action_spaces = {a: types.SimpleNamespace(n=3)
                         for a in possible_agents}

        def __init__(self, max_steps=40):
            self.max_steps = max_steps
            self.pos = {}
            self.t = 0

        def _obs(self):
            d = self.L - 1
            return {"left": np.array([self.pos["left"] / d,
                                      self.pos["right"] / d], np.float32),
                    "right": np.array([self.pos["right"] / d,
                                       self.pos["left"] / d], np.float32)}

        def reset(self, *, seed=None, options=None):
            self.pos = {"left": 0, "right": self.L - 1}
            self.t = 0
            return self._obs(), {}

        def step(self, action_dict):
            self.t += 1
            goals = {"left": self.L - 1, "right": 0}
            rew = {}
            for a, act in action_dict.items():
                prev = abs(self.pos[a] - goals[a])
                self.pos[a] = int(np.clip(self.pos[a] + (int(act) - 1),
                                          0, self.L - 1))
                rew[a] = 0.2 * (prev - abs(self.pos[a] - goals[a])) - 0.02
            done = all(self.pos[a] == goals[a] for a in self.possible_agents)
            if done:
                for a in rew:
                    rew[a] += 1.0
            trunc = self.t >= self.max_steps and not done
            return (self._obs(), rew, {"__all__": done},
                    {"__all__": trunc}, {})

        def close(self):
            pass

    return CooperativeCorridor()


def make_synth_atari():
    """bench_rl.py's SynthAtari without gymnasium: 84x84x4 frames in
    [0, 1), 6 actions, reward 1 for action 3, 200-step episodes."""
    import types

    import numpy as np

    class SynthAtari:
        observation_space = types.SimpleNamespace(shape=(84, 84, 4))
        action_space = types.SimpleNamespace(n=6)

        def __init__(self):
            self._t = 0
            self._rng = np.random.default_rng(0)

        def _obs(self):
            return self._rng.random((84, 84, 4), np.float32)

        def reset(self, *, seed=None, options=None):
            self._t = 0
            return self._obs(), {}

        def step(self, action):
            self._t += 1
            return self._obs(), float(action == 3), self._t >= 200, \
                False, {}

    return SynthAtari()


def _rl_leaf_errs(a, b, path=""):
    """``(path, error, beyond, size)`` of every leaf of two numpy trees
    (dicts/lists): the largest difference relative to max(the leaf's
    largest |value| in ``b``, 1e-3), and how many of its ``size``
    elements part by more than RL_TOL of that; an integer leaf's error
    is 0 if equal, else inf."""
    import numpy as np

    if isinstance(a, dict):
        return [e for k in b for e in _rl_leaf_errs(a[k], b[k],
                                                    f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [e for i, (x, y) in enumerate(zip(a, b))
                for e in _rl_leaf_errs(x, y, f"{path}/{i}")]
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"leaf {path}: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    if b.dtype.kind in "iu":
        equal = np.array_equal(a, b)
        return [(path, 0.0 if equal else math.inf, 0 if equal else b.size,
                 b.size)]
    diff = np.abs(a.astype(np.float64) - b) / max(float(np.abs(b).max()),
                                                  1e-3)
    return [(path, float(diff.max()), int((diff > RL_TOL).sum()), b.size)]


def _rl_hold(got, want, conv: bool):
    """Hold a learner state from the card to the CPU's: ``(ok, text)``.
    Dense learners: every leaf within RL_TOL. Conv learners: the Adam
    moments within RL_CONV_TOL, and at most RL_FLIPS of the parameters
    (and targets) beyond RL_TOL; integer leaves equal either way."""
    errs = _rl_leaf_errs(got, want)
    path, worst = max(((p, e) for p, e, _, _ in errs), key=lambda e: e[1])
    if not conv:
        return worst <= RL_TOL, f"{worst:.3g} ({path})"
    moments = [e for p, e, _, _ in errs if "opt_state" in p.split("/")]
    params = [(n, size) for p, _, n, size in errs
              if "opt_state" not in p.split("/")]
    beyond, total = (sum(x) for x in zip(*params))
    ok = max(moments) <= RL_CONV_TOL and beyond <= RL_FLIPS * total and \
        all(e < math.inf for _, e, _, _ in errs)
    return ok, (f"moments {max(moments):.3g} (tolerance {RL_CONV_TOL}), "
                f"{beyond} of {total} parameters beyond {RL_TOL} (at most "
                f"{RL_FLIPS:g} of them), worst leaf {worst:.3g} ({path})")


def _rl_tree_err(a, b) -> float:
    return max(e for _, e, _, _ in _rl_leaf_errs(a, b))


def _rl_metric_err(a: dict, b: dict) -> float:
    import numpy as np

    if set(a) != set(b):
        raise AssertionError(f"metrics {sorted(a)} vs {sorted(b)}")
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64) - b[k])
                            / np.maximum(np.abs(b[k]), 1.0))) for k in b)


def rl_phase(card: str) -> None:
    """The rllib numeric core (``ray_tpu_torch.rllib``): (a) every learner
    on the card against the CPU from the same numpy weights and batches
    at f32 (MLP and 42x42x4 conv PPO, DQN, SAC with and without CQL, BC,
    MARWIL), SAC's threefry draws bit-equal; (b) PPO on a numpy CartPole,
    learner on the card: the reference's learning gate at its test's
    configuration, then bench_rl.py's configuration to the solved stop
    (iterations, wall time, env steps/s, learner update ms); (c) the
    Nature-CNN learner at 84x84x4: update ms, peak memory, one update
    against the CPU; (d) a ``LearnerGroup`` of two ``RankPool`` learners
    on this card equal to two local learners on the batch halves,
    averaged; (e) multi-agent PPO: each module's learner card vs CPU,
    then the reference's CooperativeCorridor gate; (f) DreamerV3 at XS:
    the algorithm's iterations and one update card vs CPU, its samples
    compared index for index; (g) IMPALA at bench_rl.py's Pong-shaped
    configuration on runner and aggregator threads (env steps/s, update
    ms, one V-trace update card vs CPU), then the APPO smoke. No TPU
    kernel is on this path (dense products, cuDNN convolutions, Adam)."""
    import functools

    import numpy as np
    import torch

    from ray_tpu_torch._private import tree
    from ray_tpu_torch.rllib import (BCConfig, DQNLearner, LearnerGroup,
                                     MARWILConfig, PPOConfig, PPOLearner,
                                     RLModuleSpec, SACLearner,
                                     SingleAgentEnvRunner, compute_gae,
                                     params_to_numpy)
    from ray_tpu_torch.rllib.dqn import EpsilonGreedyModule
    from ray_tpu_torch.rllib.learner import mean_state
    from ray_tpu_torch.rllib.sac import SquashedGaussianModule

    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)
    mlp = RLModuleSpec(obs_dim=4, num_actions=2, hidden=RL_HIDDEN)
    runner = SingleAgentEnvRunner(make_cartpole, mlp, RL_ENVS, RL_FRAGMENT,
                                  seed=0)
    frag = runner.sample()
    adv, vtarg = compute_gae(frag["rewards"], frag["values"],
                             frag["next_values"], frag["dones"],
                             frag["truncateds"], frag["_shape"])
    ppo_batch = {"obs": frag["obs"], "actions": frag["actions"],
                 "logp_old": frag["logp"], "advantages": adv,
                 "value_targets": vtarg}
    n = len(frag)

    def conv_batch(shape, actions, size):
        return {"obs": rng.random((size,) + shape, np.float32),
                "actions": rng.integers(0, actions, size),
                "logp_old": (np.log(1.0 / actions) + 0.1
                             * rng.standard_normal(size)).astype(np.float32),
                "advantages": rng.standard_normal(size).astype(np.float32),
                "value_targets": rng.standard_normal(size).astype(
                    np.float32)}

    def transitions(obs_dim, act, size, continuous):
        b = {"obs": rng.standard_normal((size, obs_dim)).astype(np.float32),
             "rewards": rng.standard_normal(size).astype(np.float32),
             "next_obs": rng.standard_normal((size, obs_dim)).astype(
                 np.float32),
             "dones": (rng.random(size) < 0.05).astype(np.float32),
             "weights": rng.random(size).astype(np.float32)}
        b["actions"] = (rng.uniform(-2, 2, (size, act)).astype(np.float32)
                        if continuous else rng.integers(0, act, size))
        return b

    conv = RLModuleSpec(obs_dim=42 * 42 * 4, num_actions=6, hidden=(256,),
                        obs_shape=(42, 42, 4), conv=True)
    conv42 = conv_batch((42, 42, 4), 6, 256)
    dqn = RLModuleSpec(obs_dim=4, num_actions=2, hidden=RL_HIDDEN,
                       module_cls=EpsilonGreedyModule)
    dqn_batches = [transitions(4, 2, 128, False) for _ in range(3)]
    box = dict(obs_dim=3, num_actions=1, hidden=RL_HIDDEN, continuous=True,
               action_low=np.array([-2.0], np.float32),
               action_high=np.array([2.0], np.float32),
               module_cls=SquashedGaussianModule)
    sac = RLModuleSpec(**box)
    sac_batches = [transitions(3, 1, 256, True) for _ in range(3)]
    offline = {"obs": frag["obs"], "actions": frag["actions"],
               "rewards": frag["rewards"],
               "dones": frag["dones"].astype(np.float32)}

    def ppo_run(spec, batch):
        def run(dev):
            learner = PPOLearner(spec, seed=0, device=dev)
            ms = [learner.update(batch, minibatch_size=128, num_epochs=1,
                                 shuffle_seed=s) for s in (0, 1)]
            return ms, learner.get_state()
        return run

    def dqn_run(dev):
        learner = DQNLearner(dqn, seed=0, device=dev)
        ms = []
        for i, b in enumerate(dqn_batches):
            m = learner.update(b)
            m["td_errors"] = m["td_errors"].astype(np.float64)
            ms.append(m)
            if i == 1:
                learner.sync_target()
        return ms, learner.get_state()

    def sac_run(cql_weight):
        def run(dev):
            learner = SACLearner(sac, seed=0, cql_weight=cql_weight,
                                 device=dev)
            ms = [learner.update(b) for b in sac_batches]
            state = learner.get_state()
            state["key"] = learner._rng_key.cpu().numpy()
            return ms, state
        return run

    def offline_run(cls, **kw):
        def run(dev):
            algo = (cls().offline(offline, obs_dim=4, num_actions=2)
                    .training(minibatch_size=128, num_epochs=1, **kw)
                    .learners(device=dev).debugging(seed=0))
            algo = algo.algo_class(algo)
            ms = [algo.train() for _ in range(2)]
            return ms, {"params": algo.params, "opt_state": algo.opt_state}
        return run

    cases = {"ppo_mlp": ppo_run(mlp, ppo_batch),
             "ppo_conv_42x42x4": ppo_run(conv, conv42),
             "dqn": dqn_run, "sac": sac_run(0.0), "sac_cql": sac_run(5.0),
             "bc": offline_run(BCConfig),
             "marwil": offline_run(MARWILConfig, beta=1.0)}
    held = {}
    for name, run in cases.items():
        got = {dev: run(dev) for dev in ("cpu", "cuda")}
        (m_cpu, s_cpu), (m_gpu, s_gpu) = got["cpu"], got["cuda"]
        s_cpu, s_gpu = params_to_numpy(s_cpu), params_to_numpy(s_gpu)
        if name.startswith("sac") and not np.array_equal(s_cpu.pop("key"),
                                                         s_gpu.pop("key")):
            raise AssertionError(f"rl (a) {name}: the key chain parted")
        metric = max(_rl_metric_err(g, c) for g, c in zip(m_gpu, m_cpu))
        ok, text = _rl_hold(s_gpu, s_cpu, conv="conv" in name)
        held[name] = (ok and metric <= RL_TOL, f"{name}: metrics "
                      f"{metric:.3g}, state {text}")
    # SAC's draws: one step's noise from one key, card vs CPU, bit for
    # bit (the CQL learner draws all four)
    learner = {dev: SACLearner(sac, seed=0, cql_weight=5.0, device=dev)
               for dev in ("cpu", "cuda")}
    key = torch.tensor([0, 12], dtype=torch.int64)
    d_cpu = learner["cpu"].draws(key, 256)
    d_gpu = learner["cuda"].draws(key.cuda(), 256)
    draws_equal = all(torch.equal(d_gpu[k].cpu().view(torch.int32),
                                  d_cpu[k].view(torch.int32)) for k in d_cpu)
    log(f"rl (a) card vs CPU at f32 (TF32 off) [{card}]: largest metric "
        f"error (relative to max(|value|, 1); tolerance {RL_TOL}) and leaf "
        f"error of parameters, targets and Adam moments (relative to "
        f"max(|leaf|, 1e-3); tolerance {RL_TOL}, conv learners as "
        f"RL_CONV_TOL/RL_FLIPS say) per learner: "
        + "; ".join(text for _, text in held.values())
        + f"; SAC draws (next, pi, cql_rand, cql_pi;"
        f" {', '.join(f'{k} {tuple(v.shape)}' for k, v in d_cpu.items())})"
        f" bit-equal card vs CPU: {draws_equal}; key chains equal after "
        f"3 updates")
    if not draws_equal or not all(ok for ok, _ in held.values()):
        raise AssertionError("rl (a): a learner on the card disagrees "
                             "with the CPU")

    # (b) PPO, learner on the card: the reference's learning gate at its
    # test's configuration, then bench_rl.py's run to the solved stop
    def ppo(training, fragment):
        return (PPOConfig().environment(env_creator=make_cartpole)
                .env_runners(num_env_runners=0,
                             num_envs_per_env_runner=RL_ENVS,
                             rollout_fragment_length=fragment)
                .rl_module(hidden=RL_HIDDEN).training(**training)
                .learners(device="cuda").debugging(seed=0)).build()

    algo = ppo(RL_GATE, RL_GATE_FRAGMENT)
    t = time.perf_counter()
    try:
        gate = max(algo.train()["episode_return_mean"]
                   for _ in range(RL_GATE_ITERS))
    finally:
        algo.stop()
    t_gate = time.perf_counter() - t
    algo = ppo(RL_PPO, RL_FRAGMENT)
    learner = algo.learner_group.local
    update = learner.update
    update_ms = []

    def timed_update(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(*a, **kw)           # float() of the metrics syncs
        update_ms.append((time.perf_counter() - t) * 1e3)
        return out

    learner.update = timed_update
    best, solved, m = 0.0, None, {}
    t = time.perf_counter()
    try:
        for i in range(RL_MAX_ITERS):
            m = algo.train()
            best = max(best, m["episode_return_mean"])
            if m["num_episodes"] >= 20 and \
                    m["episode_return_mean"] >= RL_SOLVED:
                solved = i + 1
                break
        wall = time.perf_counter() - t
        steps = algo._timesteps
    finally:
        algo.stop()
    steps_per_update = (RL_PPO["train_batch_size"]
                        // RL_PPO["minibatch_size"] * RL_PPO["num_epochs"])
    outcome = (f"solved (mean >= {RL_SOLVED} over >= 20 episodes) after "
               f"{solved}" if solved else f"not solved in {i + 1}")
    log(f"rl (b) PPO CartPole-v1 (numpy, in the script), learner on the "
        f"card [{card}]: the reference's gate at its test's configuration "
        f"({RL_ENVS} envs x fragment {RL_GATE_FRAGMENT}, {RL_GATE}): best "
        f"mean return {gate:.2f} within {RL_GATE_ITERS} iterations (gate "
        f">= {RL_GATE_RETURN}; {t_gate:.3f} s); bench_rl.py's "
        f"configuration (hidden {RL_HIDDEN}, {RL_ENVS} envs x fragment "
        f"{RL_FRAGMENT}, {RL_PPO}, seed 0): {outcome} iterations, {steps} "
        f"env steps in {wall:.3f} s = {steps / wall:.1f} env steps/s; last "
        f"mean return {m['episode_return_mean']:.2f}, best {best:.2f}; "
        f"learner update ({steps_per_update} minibatch steps) p50 "
        f"{p50(update_ms):.3f} ms, first {update_ms[0]:.3f} ms, "
        f"{sum(update_ms) / 1e3 / wall:.3f} of the wall time (the rest: "
        f"sampling, GAE and weight sync on the host)")
    if not gate >= RL_GATE_RETURN:
        raise AssertionError(f"rl (b): PPO's best mean return within "
                             f"{RL_GATE_ITERS} iterations is {gate}")

    # (c) the Nature-CNN learner at full width
    shape = RL_ATARI["obs_shape"]
    atari = RLModuleSpec(obs_dim=int(np.prod(shape)),
                         num_actions=RL_ATARI["num_actions"],
                         hidden=(RL_ATARI["torso"],), obs_shape=shape,
                         conv=True)
    batch = conv_batch(shape, RL_ATARI["num_actions"], RL_ATARI["batch"])
    states = {}
    for dev in ("cpu", "cuda"):
        learner = PPOLearner(atari, seed=0, device=dev)
        states[dev] = (learner.update(batch), learner.get_state())
    metric = _rl_metric_err(states["cuda"][0], states["cpu"][0])
    ok, text = _rl_hold(states["cuda"][1], states["cpu"][1], conv=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(23):
        t = time.perf_counter()
        learner.update(batch)
        if i >= 3:
            ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(v.size for v in tree.leaves(states["cpu"][1]["params"]))
    log(f"rl (c) Nature-CNN PPO learner ({shape[0]}x{shape[1]}x{shape[2]}, "
        f"torso {RL_ATARI['torso']}, {RL_ATARI['num_actions']} actions, "
        f"{n_params} params, minibatch {RL_ATARI['batch']}) [{card}]: one "
        f"update (batch in from the host, forward, backward, clipped Adam, "
        f"metrics back) p50 {p50(ms):.3f} ms over 20 after 3, min "
        f"{min(ms):.3f}; peak memory {peak / 2**20:.1f} MiB; one update card"
        f" vs CPU at f32: metrics {metric:.3g} (tolerance {RL_TOL}), state "
        f"{text}")
    if not ok or metric > RL_TOL:
        raise AssertionError("rl (c): the Nature-CNN learner on the card "
                             "disagrees with the CPU")

    # (d) two RankPool learners on this card against two local learners
    # on the batch halves, averaged, over two updates (the first warms
    # each rank's CUDA libraries)
    kw = dict(minibatch_size=64, num_epochs=2)
    half = n // 2
    t = time.perf_counter()
    group = LearnerGroup(functools.partial(PPOLearner, mlp, seed=0),
                         num_learners=2, devices=("cuda:0", "cuda:0"))
    try:
        t_start = time.perf_counter() - t
        t_update, got_m = [], []
        for seed in (3, 4):
            t = time.perf_counter()
            got_m.append(group.update(ppo_batch, shuffle_seed=seed, **kw))
            t_update.append((time.perf_counter() - t) * 1e3)
        got = group.get_state()
    finally:
        group.stop()
    pair = [PPOLearner(mlp, seed=0, device="cuda") for _ in range(2)]
    want_m = []
    for seed in (3, 4):
        ms = [p.update({k: v[lo:lo + half] for k, v in ppo_batch.items()},
                       shuffle_seed=seed, **kw)
              for p, lo in zip(pair, (0, half))]
        want_m.append({k: float(np.mean([m[k] for m in ms]))
                       for k in ms[0]})
        averaged = mean_state([p.get_state() for p in pair])
        for p in pair:
            p.set_state(averaged)
    err = _rl_tree_err(got, averaged)
    equal = err == 0.0 and got_m == want_m
    log(f"rl (d) LearnerGroup(num_learners=2) on two RankPool ranks on "
        f"this card (gloo) [{card}]: state and metrics after two updates "
        f"({n} rows split in halves, {kw}, shuffle seeds 3 and 4) equal to "
        f"two local learners', averaged after each: {equal} (state leaf "
        f"error {err:.3g}); start {t_start:.3f} s,"
        f" updates {[round(x, 3) for x in t_update]} ms (two processes on "
        f"one card, states through the host) "
        f"[{time.perf_counter() - t_phase:.1f} s in the phase]")
    if not equal:
        raise AssertionError("rl (d): the learner group differs from the "
                             "averaged pair")

    rl_multi_agent_part(card)
    rl_dreamer_part(card)
    rl_impala_part(card)


def _timed_updates(learner, sink, first=None):
    """Wrap ``learner.update`` to append each call's ms (host clock,
    synchronised on both sides) to ``sink``; ``first`` (a list) keeps
    the first call's arguments."""
    import torch

    update = learner.update

    def timed(*a, **kw):
        if first is not None and not first:
            first.append((a, kw))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(*a, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t) * 1e3)
        return out

    learner.update = timed


def rl_multi_agent_part(card: str) -> None:
    """(e) Multi-agent PPO (``ray_tpu_torch.rllib.multi_agent``): each
    module's learner card vs CPU on the same numpy weights and per-stream
    GAE batch, then the reference's corridor gate with both learners on
    the card."""
    import numpy as np

    from ray_tpu_torch.rllib import (MultiAgentEnvRunner, PPOConfig,
                                     PPOLearner, spec_from_spaces)
    from ray_tpu_torch.rllib.multi_agent import stream_gae_batch

    t_part = time.perf_counter()
    env = make_corridor()
    specs = {a: spec_from_spaces(env.observation_spaces[a],
                                 env.action_spaces[a], RL_MA_HIDDEN)
             for a in env.possible_agents}
    runner = MultiAgentEnvRunner(make_corridor, specs, lambda aid, i: aid,
                                 RL_MA_ENVS, RL_MA_FRAGMENT, seed=0)
    frags = runner.sample()
    held = {}
    for mid, spec in sorted(specs.items()):
        batch = stream_gae_batch([frags[mid]], 0.99, 0.95)
        got = {}
        for dev in ("cpu", "cuda"):
            learner = PPOLearner(spec, lr=RL_MA["lr"],
                                 entropy_coeff=RL_MA["entropy_coeff"],
                                 seed=0, device=dev)
            ms = [learner.update(batch, minibatch_size=RL_MA[
                "minibatch_size"], num_epochs=2, shuffle_seed=s)
                for s in (0, 1)]
            got[dev] = (ms, learner.get_state())
        metric = max(_rl_metric_err(g, c)
                     for g, c in zip(got["cuda"][0], got["cpu"][0]))
        ok, text = _rl_hold(got["cuda"][1], got["cpu"][1], conv=False)
        held[mid] = (ok and metric <= RL_TOL,
                     f"{mid} ({len(batch['obs'])} rows): metrics "
                     f"{metric:.3g}, state {text}")
    log(f"rl (e) multi-agent PPO, each module's learner card vs CPU at f32 "
        f"after two updates of 2 epochs (minibatch "
        f"{RL_MA['minibatch_size']}) on its per-stream GAE batch from one "
        f"CooperativeCorridor fragment ({RL_MA_ENVS} envs x "
        f"{RL_MA_FRAGMENT}) [{card}]: "
        + "; ".join(text for _, text in held.values())
        + f" (tolerance {RL_TOL})")
    if not all(ok for ok, _ in held.values()):
        raise AssertionError("rl (e): a module's learner on the card "
                             "disagrees with the CPU")

    algo = (PPOConfig().environment(env_creator=make_corridor)
            .multi_agent(policies={"left", "right"},
                         policy_mapping_fn=lambda aid, i: aid)
            .env_runners(num_env_runners=0,
                         num_envs_per_env_runner=RL_MA_ENVS,
                         rollout_fragment_length=RL_MA_FRAGMENT)
            .rl_module(hidden=RL_MA_HIDDEN).training(**RL_MA)
            .learners(device="cuda").debugging(seed=0)).build()
    update_ms = []
    for group in algo.learner_group.groups.values():
        _timed_updates(group.local, update_ms)
    best, returns = -math.inf, []
    t = time.perf_counter()
    try:
        for _ in range(RL_MA_ITERS):
            m = algo.train()
            returns.append(round(m["episode_return_mean"], 4))
            best = max(best, m["episode_return_mean"])
            if best >= RL_MA_RETURN:
                break
        wall = time.perf_counter() - t
        steps = algo._timesteps
    finally:
        algo.stop()
    log(f"rl (e) multi-agent PPO gate (the reference's test configuration: "
        f"2 modules, hidden {RL_MA_HIDDEN}, {RL_MA_ENVS} envs x "
        f"{RL_MA_FRAGMENT}, {RL_MA}, seed 0), learners on the card "
        f"[{card}]: best joint return {best:.4f} after {len(returns)} "
        f"iterations (gate >= {RL_MA_RETURN} within {RL_MA_ITERS}; means "
        f"{returns}); {steps} agent steps in {wall:.3f} s = "
        f"{steps / wall:.1f} agent steps/s; one module's update p50 "
        f"{p50(update_ms):.3f} ms over {len(update_ms)}, first "
        f"{update_ms[0]:.3f} ms, {sum(update_ms) / 1e3 / wall:.3f} of the "
        f"wall time [{time.perf_counter() - t_part:.1f} s in the part]")
    if not best >= RL_MA_RETURN:
        raise AssertionError(f"rl (e): the corridor's best joint return "
                             f"within {RL_MA_ITERS} iterations is {best}")


def rl_dreamer_part(card: str) -> None:
    """(f) DreamerV3 at XS on the numpy CartPole, learner on the card:
    the algorithm's iterations (update ms, peak memory, device events
    of one update), then one update held card vs CPU as RL_DV3_ITERS'
    comment says."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch._private import prng, tree
    from ray_tpu_torch.rllib import DreamerV3Config, DreamerV3Learner

    t_part = time.perf_counter()
    cfg = (DreamerV3Config().environment(env_creator=make_cartpole)
           .learners(device="cuda").debugging(seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    algo = cfg.build()
    learner = algo._learner
    update_ms = []
    _timed_updates(learner, update_ms)
    t = time.perf_counter()
    try:
        metrics = [algo.train() for _ in range(RL_DV3_ITERS)]
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        state = learner.get_state()
        batch = algo._replay.sample(cfg.batch_seqs)
        spec = algo.module_spec
    finally:
        algo.stop()
    losses = {k: v for k, v in metrics[-1].items()
              if k == "loss" or k.startswith(("wm/", "ac/"))}
    finite = all(np.isfinite(v) for m in metrics for k, v in m.items()
                 if k == "loss" or k.startswith(("wm/", "ac/")))
    log(f"rl (f) DreamerV3 XS (deter {cfg.deter_dim}, units {cfg.units}, "
        f"{cfg.stoch_dims}x{cfg.stoch_classes} latents, horizon "
        f"{cfg.horizon}, {cfg.batch_seqs} x {cfg.seq_len} sequences, "
        f"{sum(v.size for v in tree.leaves(state['params']))} params) on "
        f"CartPole, learner on the card [{card}]: {RL_DV3_ITERS} "
        f"iterations, {len(update_ms)} updates in {wall:.3f} s; update p50 "
        f"{p50(update_ms):.3f} ms, first {update_ms[0]:.3f} ms; peak "
        f"memory {peak / 2**20:.1f} MiB; last iteration "
        + ", ".join(f"{k} {v:.4g}" for k, v in losses.items())
        + f"; every loss finite: {finite}")
    if len(update_ms) < 16 or not finite:
        raise AssertionError(f"rl (f): {len(update_ms)} updates, finite "
                             f"losses {finite}")

    key = torch.tensor([0, 13], dtype=torch.int64)
    B, L = cfg.batch_seqs, cfg.seq_len

    def fresh(dev):
        out = DreamerV3Learner(spec, cfg, seed=0, device=dev)
        out.set_state(state)
        out._key = key.to(dev)
        return out

    learners = {dev: fresh(dev) for dev in ("cpu", "cuda")}
    noise = {}
    for dev, lrn in learners.items():
        _, k = prng.split(lrn._key)
        noise[dev] = {n: v.cpu() for n, v in lrn.draws(k, B, L).items()}
    keys_equal = all(torch.equal(noise["cuda"][n], noise["cpu"][n])
                     for n in ("k1", "k2", "obs_keys", "img_keys", "ka",
                               "kz"))
    g_ulps = 0.0
    for n in ("obs", "act", "z"):
        ref = noise["cpu"][n].numpy()
        g_ulps = max(g_ulps, float((np.abs(noise["cuda"][n].numpy() - ref)
                                    / (np.spacing(np.abs(ref)) + 2.0 ** -23)
                                    ).max()))
    m_gpu = learners["cuda"].update(batch)
    s_gpu = learners["cuda"].get_state()
    d_gpu = {k: v.cpu() for k, v in learners["cuda"].last_draws.items()}
    learners["cpu"].update(batch)
    d_cpu = learners["cpu"].last_draws
    flips = {k: f"{int((d_gpu[k] != d_cpu[k]).sum())} of {d_gpu[k].numel()}"
             for k in d_gpu}
    replay = fresh("cpu")
    replay.draws = lambda k, b, l: noise["cuda"]
    m_rep = replay.update(batch)
    s_rep = replay.get_state()
    same = {k: int((replay.last_draws[k] != d_gpu[k]).sum()) for k in d_gpu}
    metric = _rl_metric_err(m_gpu, m_rep)
    errs = _rl_leaf_errs(s_gpu, s_rep)
    side = max(e for p, e, _, _ in errs if not p.startswith("/params/"))
    params = [(p.startswith("/params/actor/"), e, n, size)
              for p, e, n, size in errs if p.startswith("/params/")]
    beyond, total = (sum(x) for x in zip(*[
        (n, size) for actor, _, n, size in params if not actor]))
    actor_beyond, actor_total = (sum(x) for x in zip(*[
        (n, size) for actor, _, n, size in params if actor]))
    worst = max(e for _, e, _, _ in params)
    key_chain = torch.equal(learners["cuda"]._key.cpu(),
                            learners["cpu"]._key)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        learners["cuda"].update(batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t) * 1e3
    busy_ms, rows = device_rows(prof)
    events = sum(c for _, _, c in rows)
    ok = (keys_equal and key_chain and g_ulps <= GUMBEL_ULPS
          and not any(same.values()) and metric <= RL_TOL
          and side <= RL_TOL and beyond <= RL_FLIPS * total)
    log(f"rl (f) one DreamerV3 update card vs CPU from the state after "
        f"the run, one replay batch, key {key.tolist()} [{card}]: keys "
        f"(k1, k2, split(k1, {L}), split(k2, {cfg.horizon}), ka, kz) "
        f"bit-equal {keys_equal}, key chains equal after {key_chain}; "
        f"Gumbel noise worst {g_ulps:.3g} (ulp + 2**-23) units (bound "
        f"{GUMBEL_ULPS}); samples flipped card vs CPU, each on its own "
        f"noise: {flips}; the CPU rerun on the card's noise draws the "
        f"card's samples ({same} differ): metrics {metric:.3g}, Adam "
        f"moments and slow critic {side:.3g} (tolerance {RL_TOL}), "
        f"{beyond} of {total} parameters outside the actor beyond "
        f"{RL_TOL} (at most {RL_FLIPS:g} of them), the actor's "
        f"{actor_beyond} of {actor_total} (worst leaf {worst:.3g}); one "
        f"profiled update "
        f"{prof_ms:.3f} ms, {events} device events (kernels, copies, "
        f"memsets), device busy {busy_ms:.3f} ms "
        f"[{time.perf_counter() - t_part:.1f} s in the part]")
    if not ok:
        raise AssertionError("rl (f): the DreamerV3 update on the card "
                             "disagrees with the CPU")


def rl_impala_part(card: str) -> None:
    """(g) IMPALA at bench_rl.py's Pong-shaped configuration, learner on
    the card: env steps/s through the pipeline (runner and aggregator
    threads), learner update ms; one V-trace batch's update card vs CPU
    (held as (c)'s conv learner); then the reference's APPO smoke."""
    import numpy as np

    from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig, PPOLearner

    t_part = time.perf_counter()
    cfg = (IMPALAConfig().environment(env_creator=make_synth_atari)
           .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                        rollout_fragment_length=32)
           .rl_module(use_conv=True)
           .training(num_aggregation_workers=1, train_batch_size=256,
                     lr=3e-4)
           .learners(device="cuda").debugging(seed=0))
    algo = cfg.build()
    update_ms, first = [], []
    _timed_updates(algo.learner_group.local, update_ms, first)
    t = time.perf_counter()
    try:
        metrics = [algo.train() for _ in range(RL_IMPALA_ITERS)]
        wall = time.perf_counter() - t
        steps = algo._timesteps
        spec = algo.module_spec
    finally:
        algo.stop()
    fragments = sum(m["num_fragments"] for m in metrics)
    finite = all(np.isfinite(m["total_loss"]) for m in metrics)
    (batch,), kw = first[0]
    got = {}
    for dev in ("cpu", "cuda"):
        learner = PPOLearner(spec, lr=cfg.lr, clip_param=cfg.clip_param,
                             vf_coeff=cfg.vf_coeff,
                             entropy_coeff=cfg.entropy_coeff,
                             grad_clip=cfg.grad_clip, seed=0, device=dev)
        got[dev] = (learner.update(batch, **kw), learner.get_state())
    metric = _rl_metric_err(got["cuda"][0], got["cpu"][0])
    ok, text = _rl_hold(got["cuda"][1], got["cpu"][1], conv=True)
    log(f"rl (g) IMPALA, bench_rl.py's Pong-shaped configuration (2 "
        f"Nature-CNN runner threads x 2 envs of 84x84x4, 6 actions, "
        f"fragments of 32, 1 aggregator thread, lr 3e-4, seed 0), learner "
        f"on the card [{card}]: {RL_IMPALA_ITERS} iterations, {steps} env "
        f"steps ({fragments} fragments) in {wall:.3f} s = "
        f"{steps / wall:.1f} env steps/s; learner update (one pass, "
        f"minibatch {cfg.minibatch_size}) p50 {p50(update_ms):.3f} ms, "
        f"first {update_ms[0]:.3f} ms, {sum(update_ms) / 1e3 / wall:.3f} of "
        f"the wall time; losses finite: {finite}; the first V-trace batch "
        f"({len(batch['obs'])} rows) card vs CPU from the same weights: "
        f"metrics {metric:.3g} (tolerance {RL_TOL}), state {text}")
    if not finite or not ok or metric > RL_TOL:
        raise AssertionError("rl (g): IMPALA's learner on the card "
                             "disagrees with the CPU, or a loss is not "
                             "finite")

    appo = (APPOConfig().environment(env_creator=make_cartpole)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=64)
            .training(train_batch_size=256, minibatch_size=128,
                      num_epochs=2, lr=5e-4, num_aggregation_workers=1)
            .learners(device="cuda").debugging(seed=0)).build()
    try:
        m = [appo.train() for _ in range(RL_APPO_ITERS)][-1]
    finally:
        appo.stop()
    log(f"rl (g) APPO smoke (the reference's: CartPole, 2 runner threads x "
        f"2 envs, fragments of 64, 2 epochs, 1 aggregator) [{card}]: "
        f"{RL_APPO_ITERS} iterations, last total_loss "
        f"{m['total_loss']:.6g}, {m['num_env_steps_trained']} env steps "
        f"trained [{time.perf_counter() - t_part:.1f} s in the part]")
    if not np.isfinite(m["total_loss"]) or m["num_env_steps_trained"] <= 0:
        raise AssertionError("rl (g): the APPO smoke failed")


def serve(params, cfg, reqs, *, device, attn_kernel=None, seeds=None,
          descs=None, slots=16, chunk=8, max_len=1024, page_size=16,
          **engine_kw):
    """Queue every request (``seeds[i]`` seeds request i's PRNG lane),
    start the driver, drain all streams from their own threads. With
    ``descs`` (handoff descriptors, one per request) the requests are
    admitted with ``admit_prefilled`` instead. Other keywords go to the
    engine (``kv_dtype``, ``temperature``, ``paged``, ``spec_decode``,
    ``role``, ...). Returns (streams, ttft_s, tpot_s, wall_s, stats)."""
    import numpy as np
    import torch

    from ray_tpu_torch.serve.batching import _EngineStream
    from ray_tpu_torch.serve.engine import DecodeEngine

    eng = DecodeEngine(params, cfg, slots=slots, chunk=chunk,
                       max_len=max_len, page_size=page_size,
                       attn_kernel=attn_kernel, device=device,
                       auto_start=False, **engine_kw)
    seeds = seeds or [0] * len(reqs)
    try:
        if descs is not None:
            streams = [_EngineStream(eng.admit_prefilled(d))
                       for d in descs]
        else:
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


def profile_phase(params, cfg, reqs, card, label="profile"):
    """Where a serve window's time goes on the card: the profiler's device
    time by kernel over the window's wall time (the profiler's own host
    cost inflates the wall, so the idle share is an upper bound), grouped
    into K1, the GEMMs, routing's sort/scan/index kernels and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        toks, _, _, wall, stats = serve(params, cfg, reqs,
                                        device=torch.device("cuda"),
                                        attn_kernel="cuda")
    busy_ms, rows = device_rows(prof)
    if busy_ms == 0:
        log(f"{label}: the profiler recorded no device time; device busy "
            f"share not measured")
        return
    groups = {"K1": r"paged_attention", "GEMM": r"gemm|xmma|nvjet|cutlass",
              "sort/scan/index": r"sort|scan|radix|index|scatter|gather"}
    sums = dict.fromkeys(list(groups) + ["other"], 0.0)
    for us, key, _ in rows:
        name = next((g for g, pat in groups.items()
                     if re.search(pat, key, re.I)), "other")
        sums[name] += us / 1e3
    log(f"{label} [{card}]: {len(reqs)} requests, "
        f"{sum(map(len, toks))} tokens, {stats['dispatches']} dispatches "
        f"in {wall * 1e3:.3f} ms wall (profiled); device busy "
        f"{busy_ms:.3f} ms = {busy_ms / (wall * 1e3):.3f} of the wall, "
        f"idle {1 - busy_ms / (wall * 1e3):.3f}; by group (ms): "
        + ", ".join(f"{g} {v:.3f}" for g, v in sums.items()))
    for us, key, count in sorted(rows, reverse=True)[:12]:
        log(f"  {us / 1e3:10.3f} ms  {count:6d} x  {key[:90]}")


def check_streams(name, toks, reqs, vocab):
    for i, (t, (_, m)) in enumerate(zip(toks, reqs)):
        if t.shape != (m,) or t.min() < 0 or t.max() >= vocab:
            raise AssertionError(f"{name}: stream {i} malformed: shape "
                                 f"{t.shape} (want {(m,)})")


def parting_steps(got, ref) -> dict:
    """{stream: first step where ``got`` and ``ref`` differ}."""
    return {i: int((g != r).argmax())
            for i, (g, r) in enumerate(zip(got, ref)) if not np_equal(g, r)}


def gumbel_noise(seed: int, j: int, vocab: int, device):
    """The Gumbel noise a seeded engine lane adds to ``logits / T`` for
    its token ``j`` (0 is the prefill's): the lane's key is
    ``PRNGKey(seed)`` and each token first splits it into (carry, sub),
    as ``gpt_decode._sample`` and ``_sample_slots`` do; a ``[1, V]`` draw
    equals a ``[V]`` one (row-major counters)."""
    import numpy as np
    import torch

    from ray_tpu_torch._private import prng

    key = torch.from_numpy(prng.PRNGKey(seed).astype(np.int64)).to(device)
    for _ in range(j + 1):
        key, sub = prng.split(key).unbind(0)
    return prng.gumbel(sub, (vocab,))


def tie_ratios(model, got, ref, parted, sampling=None) -> dict:
    """{stream: the parting's distance from a tie}: at the first parting
    step ``j`` of stream ``i``, the f32 logits ``L`` of the shared context
    (``reqs[i]``'s prompt and ``ref[i][:j]``, through ``params`` upcast
    to f32) give ``(max L - min(L[got], L[ref])) / (TIE_ERRS * eps)``,
    where ``eps`` is the largest gap between the bf16 forward's logits
    and ``L``. At most 1 is a near-tie (``TIE_ERRS``). With ``sampling``
    = (temperature T, per-stream seeds) the decision was ``argmax(L / T
    + g)`` with the lane's Gumbel noise ``g`` (:func:`gumbel_noise`), the
    same for both engines: the gap is taken in ``L / T + g`` and the
    bound is ``TIE_ERRS * eps / T``."""
    import dataclasses

    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt

    params, cfg, reqs = model
    c16 = dataclasses.replace(cfg, attn_backend="xla")
    c32 = dataclasses.replace(c16, dtype=torch.float32)
    p32 = {k: v.float() for k, v in params.items()}
    out = {}
    with torch.no_grad():
        for i, j in parted.items():
            ctx = np.concatenate([reqs[i][0], ref[i][:j]])[None]
            l32 = gpt.forward(p32, ctx, c32)[0, -1]
            eps = (gpt.forward(params, ctx, c16)[0, -1] - l32).abs().max()
            if sampling is not None:
                temp, seeds = sampling
                l32 = l32 / temp + gumbel_noise(seeds[i], j, l32.shape[0],
                                                l32.device)
                eps = eps / temp
            gap = l32.max() - torch.minimum(l32[int(got[i][j])],
                                            l32[int(ref[i][j])])
            out[i] = float(gap / (TIE_ERRS * eps))
    return out


def compare(name, got, ref, precision, what="kernel vs gather",
            model=None, firsts_equal=True, sampling=None):
    """Hold ``got`` against ``ref`` stream for stream: every first token
    equal, and at bf16 every parting a near-tie of ``model`` = (params,
    cfg, reqs) (``tie_ratios`` at most 1; ``sampling`` = (temperature,
    seeds) for seeded streams), else at most
    ``MAX_DIVERGED[precision]`` streams parted. ``firsts_equal=False``
    where the two prefills differ too (tensor-parallel sums): a parting
    at the first token is then held like any other. Returns the number
    of streams that parted."""
    firsts = all(g[0] == r[0] for g, r in zip(got, ref))
    where = parting_steps(got, ref)
    if precision == "bf16":
        ratios = tie_ratios(model, got, ref, where, sampling)
        worst = max(ratios.values(), default=0.0)
        shown = {i: round(r, 4) for i, r in ratios.items()}
        log(f"{name}: {what} streams: {len(where)}/{len(got)} diverge, "
            f"first divergence at {where}, distance from a tie {shown} "
            f"(largest {worst:.4f}, bound 1), first tokens all equal: "
            f"{firsts}")
        if (firsts_equal and not firsts) or \
                not all(r <= 1 for r in ratios.values()):
            raise AssertionError(f"{name}: {what}: a stream parts at more "
                                 f"than a bf16 near-tie")
        return len(where)
    budget = MAX_DIVERGED[precision]
    if isinstance(budget, float):
        budget = int(budget * len(got))
    log(f"{name}: {what} streams: {len(where)}/{len(got)} "
        f"diverge (budget {budget}), first divergence at {where}, first "
        f"tokens all equal: {firsts}")
    if (firsts_equal and not firsts) or len(where) > budget:
        raise AssertionError(f"{name}: {what} outside the divergence "
                             f"budget")
    return len(where)


#: Gumbel noise on the card against the CPU: ``log`` may round one ulp
#: apart between devices, and an ulp of the inner ``-log(u)`` reaches the
#: result as an absolute 2**-23 (``tests/test_torch_prng.py`` holds the
#: CPU against ``jax.random`` to the same bound).
GUMBEL_ULPS = 4
PRNG_SEEDS = (0, 1, 2 ** 31 - 1, -5)
SAMPLE_SHAPE = (16, 50304)          # the serving pool's logits


def prng_phase(card: str) -> None:
    """The threefry PRNG on the card: split, 32-bit draws, uniform and
    normal bit-equal to the CPU's, Gumbel noise within ``GUMBEL_ULPS``, for 16
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
                prng.uniform(k, (V,)), prng.normal(k, (V,)),
                prng.gumbel(k, (V,)))]
        for name, a, b in zip(("split", "bits", "uniform", "normal"),
                              out["cuda"], out["cpu"]):
            if a.is_floating_point():           # bits, not values
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(f"prng {name}, seed {seed}: the card "
                                     f"differs from the CPU")
        g_cpu = out["cpu"][4].numpy()
        ulps = np.abs(out["cuda"][4].numpy() - g_cpu) / (
            np.spacing(np.abs(g_cpu)) + 2.0 ** -23)
        log(f"prng seed {seed}: split/bits/uniform/normal bit-equal card "
            f"vs CPU at [{B}, {V}]; gumbel worst {ulps.max():.3g} "
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
    mix against the paged kernel engine's streams (bf16 near-ties only);
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
            what="flat vs paged-kernel", model=(params, cfg, reqs))
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
    non-speculative kernel engine's, parting at bf16 near-ties only
    (verify's arithmetic rounds differently from decode's), acceptance,
    tokens per verify round, TPOT and tok/s beside the plain engine's;
    the same at f32 (the f32 requests), held to the f32 budget. Then a
    ``spec_threshold`` run that always falls back to the chunk step (K1
    from a spec engine), and nano f32 spec streams on the card equal to
    the CPU's."""
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
        compare(f"small bf16 spec {drafter}", toks, greedy, "bf16",
                what="spec vs plain kernel engine",
                model=(params, cfg, reqs))
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
            what="fallback vs plain kernel engine",
            model=(params, cfg, reqs))
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


def handoffs(params, cfg, reqs, *, device, seeds=None, slots=16, chunk=8,
             max_len=1024, page_size=16, **engine_kw):
    """Hand every request off from a ``role="prefill"`` engine, one
    after another in request order (``seeds[i]`` seeds request i).
    Returns (descriptors, prefill engine stats)."""
    from ray_tpu_torch.serve.engine import DecodeEngine

    pre = DecodeEngine(params, cfg, slots=slots, chunk=chunk,
                       max_len=max_len, page_size=page_size, device=device,
                       role="prefill", **engine_kw)
    seeds = seeds or [0] * len(reqs)
    try:
        descs = [pre.handoff(p, m, seed=s) for (p, m), s in zip(reqs, seeds)]
        stats = pre.stats()
    finally:
        pre.shutdown()
    if stats["handoff"]["exported"] != len(reqs) or \
            stats["active_slots"] != 0:
        raise AssertionError(f"prefill engine: {stats}")
    return descs, stats


class _HandoffClock:
    """Host time of each call of the handoff's pieces while active: the
    export's device copy (the on-device gather and trim, then the copy to
    the host), the digest on both sides (``build_payload`` and
    ``verify_payload``), and the import's scatter. Device work is
    synchronised inside the clock, which the engine alone would not do,
    so the pieces are not pipelined here."""

    PIECES = (("gpt_decode", "export_slot_kv", "copy", True),
              ("gpt_decode", "export_slot_kv_paged", "copy", True),
              ("gpt_decode", "kv_to_host", "copy", False),
              ("handoff", "build_payload", "digest_out", False),
              ("handoff", "verify_payload", "digest_in", False),
              ("gpt_decode", "import_slot_kv", "scatter", True),
              ("gpt_decode", "import_slot_kv_paged", "scatter", True))

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        import torch

        from ray_tpu_torch.models import gpt_decode
        from ray_tpu_torch.serve import handoff

        mods = {"gpt_decode": gpt_decode, "handoff": handoff}
        self._saved = []
        for mod, name, piece, sync in self.PIECES:
            fn = getattr(mods[mod], name)
            self._saved.append((mods[mod], name, fn))

            def timed(*a, _fn=fn, _piece=piece, _sync=sync, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                if _sync:
                    torch.cuda.synchronize()
                self.calls.setdefault(_piece, []).append(
                    time.perf_counter() - t0)
                return out
            setattr(mods[mod], name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def per_request(self, piece, n):
        """p50 over requests of the time ``piece`` took per request (the
        export's copy is two calls per request: gather, then host)."""
        xs = self.calls.get(piece, [])
        k = max(len(xs) // n, 1)
        return p50([sum(xs[i:i + k]) for i in range(0, len(xs), k)])


def handoff_phase(params, cfg, reqs, greedy, greedy_times, reqs32, greedy8,
                  nano_args, card) -> None:
    """Disaggregated prefill/decode at GPT-2-small width (bf16), the 12
    serving requests. Paged to paged, fp and int8: a prefill-role engine
    hands every request off, a decode-role kernel engine imports and
    finishes them, each stream token-identical to the colocated kernel
    engine's of the same pool kind, K1 launched ``n_layer * chunk`` times
    per decode dispatch, no fallback. Flat to paged and paged to flat
    part at bf16 near-ties only. A torn payload falls back to a local
    prefill, counted, the same stream. Nano f32: the handoff on the card equals
    the same on the CPU at T=0 and seeded T=0.8. Prints payload bytes per
    prompt token, the export and import pieces per request, and
    decode-side TTFT/TPOT against the colocated engine."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    n = len(reqs)
    g_ttft, g_tpot = greedy_times

    def decode(descs, rq, **kw):
        pa.launches = 0
        out = serve(params, cfg, rq, device=dev, descs=descs, role="decode",
                    **kw)
        st = out[4]
        ho = st["handoff"]
        if ho["imported"] != len(rq) or ho["import_fallbacks"] or \
                st["completed"] != len(rq):
            raise AssertionError(f"decode engine {kw}: {ho}, completed "
                                 f"{st['completed']}")
        if kw.get("paged", True):
            want = cfg.n_layer * 8 * st["dispatches"]
            if pa.launches != want or not pa.launches:
                raise AssertionError(f"decode engine {kw}: K1 launches "
                                     f"{pa.launches}, want {want}")
        return out

    clock = _HandoffClock()
    with clock:
        descs, _ = handoffs(params, cfg, reqs, device=dev, attn_kernel="cuda")
        toks, ttft, tpot, wall, st = decode(descs, reqs, attn_kernel="cuda")
    per_tok = {d["nbytes"] / d["pos"] for d in descs}
    check_streams("handoff paged fp", toks, reqs, cfg.vocab_size)
    same = [np_equal(a, b) for a, b in zip(toks, greedy)]
    log(f"handoff paged->paged fp [{card}]: {sum(same)}/{n} streams "
        f"token-identical to the colocated kernel engine; K1 launches "
        f"{pa.launches} ({st['dispatches']} decode dispatches); payload "
        f"bytes per prompt token {sorted(per_tok)} (expected "
        f"{2 * cfg.n_layer * cfg.d_model * 2}); "
        f"{sum(d['nbytes'] for d in descs)} bytes shipped")
    if not all(same):
        raise AssertionError("handoff paged fp: streams differ from the "
                             "colocated kernel engine")
    if per_tok != {2 * cfg.n_layer * cfg.d_model * 2}:
        raise AssertionError(f"payload bytes per token {per_tok}")
    log(f"handoff pieces per request [{card}] (host clock, p50 of {n}; "
        f"device work synchronised): export device copy "
        f"{clock.per_request('copy', n) * 1e3:.3f} ms, export digest "
        f"{clock.per_request('digest_out', n) * 1e3:.3f} ms; import digest "
        f"{clock.per_request('digest_in', n) * 1e3:.3f} ms, import scatter "
        f"{clock.per_request('scatter', n) * 1e3:.3f} ms")
    log(f"handoff decode side [{card}]: TTFT p50 {p50(ttft) * 1e3:.3f} ms "
        f"(colocated {g_ttft * 1e3:.3f}), TPOT p50 {p50(tpot) * 1e3:.3f} ms "
        f"(colocated {g_tpot * 1e3:.3f}); {sum(map(len, toks)) / wall:.2f} "
        f"tok/s")

    descs8, _ = handoffs(params, cfg, reqs32, device=dev, attn_kernel="cuda",
                         kv_dtype="int8")
    toks8, _, tpot8, _, st8 = decode(descs8, reqs32, attn_kernel="cuda",
                                     kv_dtype="int8")
    same8 = [np_equal(a, b) for a, b in zip(toks8, greedy8)]
    log(f"handoff paged->paged int8 [{card}]: {sum(same8)}/{n} streams "
        f"token-identical to the colocated int8 kernel engine; K1 launches "
        f"{pa.launches}; payload bytes per prompt token "
        f"{sorted({d['nbytes'] / d['pos'] for d in descs8})}; TPOT p50 "
        f"{p50(tpot8) * 1e3:.3f} ms")
    if not all(same8):
        raise AssertionError("handoff paged int8: streams differ from the "
                             "colocated kernel engine")

    descs_flat, _ = handoffs(params, cfg, reqs, device=dev, paged=False)
    got, *_ = decode(descs_flat, reqs, attn_kernel="cuda")
    compare("handoff flat->paged", got, greedy, "bf16",
            what="flat prefill + paged K1 decode vs colocated kernel engine",
            model=(params, cfg, reqs))
    got, *_ = decode(descs, reqs, paged=False)
    compare("handoff paged->flat", got, greedy, "bf16",
            what="paged prefill + flat decode vs colocated kernel engine",
            model=(params, cfg, reqs))

    torn = dict(descs[0], payload=dict(descs[0]["payload"]))
    torn["payload"]["k"] = torn["payload"]["k"].copy()
    torn["payload"]["k"][0, 0] ^= 0x5555
    out, _, _, _, st = serve(params, cfg, reqs[:1], device=dev,
                             descs=[torn], role="decode",
                             attn_kernel="cuda")
    ho = st["handoff"]
    if ho["import_fallbacks"] != 1 or ho["imported"] or \
            not np_equal(out[0], greedy[0]):
        raise AssertionError(f"torn payload: {ho}, stream equal "
                             f"{np_equal(out[0], greedy[0])}")
    log("handoff torn payload: fell back to a local prefill (counted), "
        "stream identical to the colocated one")

    p_nano, nano, small, kw = nano_args
    seeds = [3, 5, 2 ** 31 - 1, -7]
    for temp in (0.0, 0.8):
        runs = {}
        for d in ("cpu", "cuda"):
            device = torch.device(d)
            k1 = "cuda" if d == "cuda" else "gather"
            ds, _ = handoffs(p_nano, nano, small, device=device, seeds=seeds,
                             temperature=temp, attn_kernel=k1, **kw)
            runs[d], *_ = serve(p_nano, nano, small, device=device,
                                descs=ds, role="decode", temperature=temp,
                                attn_kernel=k1, **kw)
        if not all(np_equal(a, b) for a, b in zip(runs["cuda"],
                                                   runs["cpu"])):
            raise AssertionError(f"nano f32 handoff T={temp}: card streams "
                                 f"differ from the CPU's")
    log("nano f32 handoff (T=0, seeded T=0.8): card streams == CPU streams")


def lifecycle_phase(params, cfg, reqs, greedy, card) -> None:
    """The card engine's lifecycle (GPT-2 small, bf16, paged, K1): an
    uninterrupted stream, then the same request with ``driver_die``
    injected mid-stream; ``supervise`` restarts the driver once and the
    ``resume_from`` resubmission completes the stream identically; a
    second death makes ``supervise`` report False. Then ``drain`` on an
    engine running the 12 requests: a new submission is refused, the
    running lanes finish, each stream equal to the colocated kernel
    engine's (the same K1 engine and admission order)."""
    import numpy as np
    import torch

    from ray_tpu_torch.serve.engine import (DecodeEngine, EngineRestartError,
                                            EngineShutdownError)

    dev = torch.device("cuda")
    kw = dict(slots=16, chunk=8, max_len=1024, page_size=16,
              attn_kernel="cuda", device=dev)
    eng = DecodeEngine(params, cfg, **kw)
    prompt, m = reqs[0]
    log("lifecycle: each injected driver death prints its traceback "
        "(the driver thread re-raises it, by design)")
    try:
        solo = np.concatenate(list(eng.stream(prompt, m)))
        eng.inject_fault("driver_die",
                         at_tokens=eng.stats()["tokens"] + m // 2)
        toks = []
        try:
            for piece in eng.stream(prompt, m):
                toks.extend(int(t) for t in piece)
        except EngineRestartError:
            pass
        if not 0 < len(toks) < m:
            raise AssertionError(f"driver_die: {len(toks)} of {m} tokens "
                                 f"before the death")
        deadline = time.monotonic() + 60
        while eng.stats()["driver_restarts"] == 0:
            if not eng.supervise() or time.monotonic() > deadline:
                raise AssertionError("supervise did not restart the driver")
            time.sleep(0.02)
        tail = np.concatenate(list(eng.stream(prompt, m,
                                              resume_from=len(toks))))
        joined = np.concatenate([np.asarray(toks, np.int32), tail])
        if not np_equal(joined, solo):
            raise AssertionError("resumed stream differs from the "
                                 "uninterrupted one")
        eng.inject_fault("driver_die", at_tokens=0)
        try:
            list(eng.stream(prompt, 8))
            raise AssertionError("second driver death did not fail the lane")
        except EngineRestartError:
            pass
        eng._thread.join(timeout=30)
        if eng.supervise() is not False:
            raise AssertionError("supervise after a second death is not "
                                 "False")
    finally:
        eng.shutdown()
    log(f"lifecycle [{card}]: driver death after {len(toks)} of {m} tokens, "
        f"one restart, resume_from={len(toks)} stream == uninterrupted "
        f"(== colocated stream: {np_equal(solo, greedy[0])}); second death: "
        f"supervise() False")

    eng = DecodeEngine(params, cfg, **kw)
    try:
        lanes = [eng.stream(p, mm) for p, mm in reqs]
        firsts = [next(s) for s in lanes]
        done = {}
        t = threading.Thread(target=lambda: done.setdefault(
            "ok", eng.drain(timeout_s=300)), daemon=True)
        t.start()
        while not eng.stats()["draining"]:
            time.sleep(0.001)
        try:
            eng.submit(prompt, 4)
            raise AssertionError("drain: a new submission was accepted")
        except EngineShutdownError:
            pass
        outs = [np.concatenate([f] + list(s))
                for f, s in zip(firsts, lanes)]
        t.join(timeout=300)
    finally:
        eng.shutdown()
    if done.get("ok") is not True:
        raise AssertionError(f"drain returned {done}")
    check_streams("drain", outs, reqs, cfg.vocab_size)
    same = [np_equal(a, b) for a, b in zip(outs, greedy)]
    log(f"drain [{card}]: new submission refused, {len(outs)} running lanes "
        f"finished, drain() True; {sum(same)}/{len(outs)} streams "
        f"token-identical to the colocated kernel engine")
    if not all(same):
        raise AssertionError("drain: streams differ from the colocated "
                             "kernel engine")


# ------------------------------------------------------- batch inference
#: The batch-inference pipeline at GPT-2-small width: 128 rows in blocks
#: of 16, 32 new tokens a row at T=0.8 (row seeds BATCH_SEED + the row's
#: index), admission bounded at queue_factor 2, on the serving phases'
#: engine knobs.
BATCH_ROWS, BATCH_BLOCK, BATCH_MAX_NEW = 128, 16, 32
BATCH_TEMP, BATCH_SEED, BATCH_QF = 0.8, 100, 2.0
BATCH_KW = dict(slots=16, chunk=8, max_len=1024, page_size=16)
#: The reference's smoke bar for slot occupancy (tests/test_data_llm.py:400).
BATCH_MIN_OCCUPANCY = 0.8
#: The nano f32 card-vs-CPU pipeline: 24 rows in blocks of 4, 12 new
#: tokens a row, on phase 4's engine knobs.
BATCH_NANO = dict(rows=24, block=4, max_new=12, seed=11)
BATCH_NANO_KW = dict(slots=4, chunk=4, max_len=128, page_size=8)


def batch_rows(n: int, vocab: int, lens=(16, 513), shared=(5, 12),
               seed: int = 7) -> list:
    """``n`` rows ``{"rid", "prompt"}`` drawn from a fixed numpy seed:
    prompts of ``lens`` tokens below ``vocab`` (and below GPT-2's 50257
    real ids); the rows in ``shared`` open with one 250-token prefix."""
    import numpy as np

    vocab = min(vocab, 50257)
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, (250,))
    rows = []
    for i in range(n):
        if i in shared:
            p = np.concatenate([prefix, rng.integers(
                0, vocab, (int(rng.integers(16, 200)),))])
        else:
            p = rng.integers(0, vocab, (int(rng.integers(*lens)),))
        rows.append({"rid": i, "prompt": p.astype(np.int32)})
    return rows


def batch_run(eng, rows, block, max_new, seed, *, progress=None,
              stop_after=None):
    """``BatchInferencer`` over ``rows`` in blocks of ``block`` on one
    engine, consumed by this thread (the pipeline's driver); with
    ``stop_after`` the consumer leaves after that many blocks. Returns
    (rows out, the inferencer, the deepest admission backlog seen: by the
    saturation policy at each admission decision and by the consuming
    loop at each block)."""
    from ray_tpu_torch.data import block as B
    from ray_tpu_torch.data import llm

    class DepthProbe(llm.EngineSaturationPolicy):
        peak = 0

        def can_add_input(self, num_in_flight):
            self.peak = max([self.peak]
                            + [e.queue_depth() for e in self.engines])
            return super().can_add_input(num_in_flight)

    policy = DepthProbe([eng], BATCH_QF)
    bi = llm.BatchInferencer(eng, max_new=max_new, seed=seed,
                             policy=policy, progress_path=progress)
    blocks = [B.rows_to_block(rows[i:i + block])
              for i in range(0, len(rows), block)]
    out, depth = [], 0
    gen = bi.run(blocks)
    try:
        for k, blk in enumerate(gen):
            depth = max(depth, eng.queue_depth())
            out += list(B.iter_rows(blk))
            if stop_after is not None and k + 1 >= stop_after:
                break
    finally:
        gen.close()
    return out, bi, max(depth, policy.peak)


def batch_infer_phase(params, cfg, card) -> None:
    """Offline batch inference (``ray_tpu_torch.data.llm``) over K1
    engines: (a) nano f32 through ``BatchInferencer``, card + K1 against
    CPU + plain, rows and tokens identical at T=0 and seeded T=0.8; (b)
    GPT-2 small bf16, 128 rows at T=0.8 against the same pipeline over a
    gather engine (bf16 near-ties only), K1 on every decode step, no
    retry or restart, slot occupancy and the admission backlog within
    their bounds, tok/s; (c) exactly once: a run left after two blocks
    resumed on a fresh engine from its progress log (committed blocks
    served with no admission, no row lost or repeated, the regenerated
    rows held to (b)'s), then a ``driver_die`` mid-run that costs one
    replay."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch.data import llm
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve.engine import DecodeEngine

    t_phase = time.perf_counter()
    # (a) nano f32: card + K1 against CPU + plain.
    nano = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.float32)
    p_nano = gpt.init_params(nano, seed=0, device="cpu")
    nrows = batch_rows(BATCH_NANO["rows"], nano.vocab_size, lens=(5, 71),
                       shared=())
    nb, nm, ns = (BATCH_NANO[k] for k in ("block", "max_new", "seed"))
    for temp in (0.0, 0.8):
        outs = {}
        for dev, kernel in (("cpu", "gather"), ("cuda", "cuda")):
            eng = DecodeEngine(p_nano, nano, temperature=temp,
                               attn_kernel=kernel, device=dev,
                               **BATCH_NANO_KW)
            try:
                pa.launches = 0
                outs[kernel], bi, _ = batch_run(eng, nrows, nb, nm, ns)
                launches, st = pa.launches, eng.stats()
            finally:
                eng.shutdown()
        want = nano.n_layer * BATCH_NANO_KW["chunk"] * st["dispatches"]
        if launches != want or launches == 0:
            raise AssertionError(f"batch nano T={temp}: K1 launches "
                                 f"{launches}, want {want}")
        got, ref = outs["cuda"], outs["gather"]
        same = [r["rid"] for r in got] == [r["rid"] for r in ref] == list(
            range(len(nrows))) and all(
            np_equal(a["generated"], b["generated"])
            for a, b in zip(got, ref))
        if not same or bi.stats["tokens"] != nm * len(nrows):
            raise AssertionError(f"batch nano f32 T={temp}: card + K1 rows "
                                 f"differ from CPU + plain")
        log(f"batch nano f32 T={temp}: {len(got)} rows in "
            f"{bi.stats['blocks']} blocks, card + K1 == CPU + plain (rows, "
            f"order, tokens); K1 launches {launches}")

    # (b) GPT-2 small bf16 at T=0.8: K1 against gather.
    dev = torch.device("cuda")
    rows = batch_rows(BATCH_ROWS, cfg.vocab_size)
    reqs = [(r["prompt"], BATCH_MAX_NEW) for r in rows]
    sampling = (BATCH_TEMP, [BATCH_SEED + i for i in range(len(rows))])
    model = (params, cfg, reqs)
    n_blocks = BATCH_ROWS // BATCH_BLOCK
    args = (BATCH_BLOCK, BATCH_MAX_NEW, BATCH_SEED)

    def engine(kernel, **kw):
        return DecodeEngine(params, cfg, temperature=BATCH_TEMP,
                            attn_kernel=kernel, device=dev, **BATCH_KW,
                            **kw)

    def well_formed(name, out):
        if [r["rid"] for r in out] != list(range(len(rows))):
            raise AssertionError(f"{name}: rows lost, repeated or out of "
                                 f"order")
        check_streams(name, [r["generated"] for r in out], reqs,
                      cfg.vocab_size)
        return [r["generated"] for r in out]

    eng = engine("gather")
    try:
        ref = well_formed("batch gather", batch_run(eng, rows, *args)[0])
    finally:
        eng.shutdown()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = engine("cuda")
    try:
        pa.launches = 0
        t0 = time.perf_counter()
        out, bi, depth = batch_run(eng, rows, *args)
        wall = time.perf_counter() - t0
        launches, st = pa.launches, eng.stats()
    finally:
        eng.shutdown()
    peak = torch.cuda.max_memory_allocated()
    got = well_formed("batch K1", out)
    want = cfg.n_layer * BATCH_KW["chunk"] * st["dispatches"]
    bound = 2 * BATCH_QF * BATCH_KW["slots"]
    log(f"batch bf16 [{card}]: {len(rows)} rows in {bi.stats['blocks']} "
        f"blocks, {bi.stats['tokens']} tokens in {wall:.4f} s = "
        f"{bi.stats['tokens'] / wall:.2f} tok/s; K1 launches {launches} "
        f"(want n_layer*chunk*dispatches = {want}); avg occupancy "
        f"{st['avg_occupancy']:.4f} (bar {BATCH_MIN_OCCUPANCY}); deepest "
        f"admission backlog {depth} (bound {bound:.0f}); retries "
        f"{bi.stats['retries']}, stream resumes "
        f"{bi.stats['stream_resumes']}, driver restarts "
        f"{st['driver_restarts']}; prefix hits {st['prefix_hits']}; peak "
        f"memory {peak / 2**20:.1f} MiB")
    if launches != want or launches == 0:
        raise AssertionError("batch bf16: K1 did not run on every decode "
                             "step")
    if bi.stats["retries"] or bi.stats["stream_resumes"] \
            or st["driver_restarts"]:
        raise AssertionError("batch bf16: an undisturbed run retried or "
                             "restarted")
    if st["avg_occupancy"] < BATCH_MIN_OCCUPANCY:
        raise AssertionError(f"batch bf16: slot occupancy "
                             f"{st['avg_occupancy']:.4f} under the bar")
    if depth > bound:
        raise AssertionError(f"batch bf16: admission backlog {depth} past "
                             f"{bound}")
    compare("batch bf16 T=0.8", got, ref, "bf16", model=model,
            sampling=sampling)

    # (c) exactly once: leave after two blocks, resume from the log.
    log_dir = tempfile.mkdtemp(prefix="batch_progress_")
    try:
        eng = engine("cuda", prefix_cache=False)
        try:
            first, _, _ = batch_run(eng, rows, *args, progress=log_dir,
                                    stop_after=2)
        finally:
            eng.shutdown()
        committed = llm.ProgressLog.scan(log_dir)
        if not 2 <= len(committed) < n_blocks:
            raise AssertionError(f"batch resume: {sorted(committed)} "
                                 f"committed before the consumer left")
        eng = engine("cuda", prefix_cache=False)
        try:
            pa.launches = 0
            out, bi, _ = batch_run(eng, rows, *args, progress=log_dir)
            launches, st = pa.launches, eng.stats()
        finally:
            eng.shutdown()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    resumed = well_formed("batch resume", out)
    n_logged = BATCH_BLOCK * len(committed)
    logged = [i for i in range(len(rows)) if i // BATCH_BLOCK in committed]
    regen = [i for i in range(len(rows)) if i // BATCH_BLOCK not in committed]
    if bi.stats["blocks_from_log"] != len(committed) \
            or bi.stats["rows_resumed_from_log"] != n_logged \
            or st["admitted"] != len(rows) - n_logged:
        raise AssertionError(f"batch resume: {bi.stats}, {st['admitted']} "
                             f"admitted for {len(rows) - n_logged} rows "
                             f"outside the log")
    if not all(np_equal(a["generated"], resumed[i])
               for i, a in enumerate(first)):
        raise AssertionError("batch resume: logged blocks differ from the "
                             "rows the first run yielded")
    # The first run's prefix cache may have served a shared prefix that
    # these engines prefill whole: a first token may part at a near-tie.
    parted = compare("batch resume (regenerated rows)",
                     [resumed[i] for i in regen], [got[i] for i in regen],
                     "bf16", what="resumed vs uninterrupted",
                     model=(params, cfg, [reqs[i] for i in regen]),
                     firsts_equal=False,
                     sampling=(BATCH_TEMP, [sampling[1][i] for i in regen]))
    log(f"batch resume [{card}]: blocks {sorted(committed)} committed when "
        f"the consumer left after 2; the resumed run served them from the "
        f"log ({len(logged)} rows, 0 admitted for them; {st['admitted']} "
        f"admitted for the other {len(regen)}), no row lost or repeated; "
        f"{parted} of {len(regen)} regenerated streams parted from the "
        f"uninterrupted run (at bf16 near-ties); K1 launches {launches}")

    # A driver death mid-run costs one replay.
    eng = engine("cuda")
    try:
        eng.inject_fault("driver_die", at_tokens=200)
        out, bi, _ = batch_run(eng, rows, *args)
        st = eng.stats()
    finally:
        eng.shutdown()
    died = well_formed("batch driver_die", out)
    if st["driver_restarts"] != 1 or bi.stats["retries"] < 1:
        raise AssertionError(f"batch driver_die: restarts "
                             f"{st['driver_restarts']}, retries "
                             f"{bi.stats['retries']}")
    parted = compare("batch driver_die", died, got, "bf16",
                     what="with a driver death vs undisturbed",
                     model=model, firsts_equal=False, sampling=sampling)
    log(f"batch driver_die [{card}]: one restart, {bi.stats['retries']} "
        f"retries, {bi.stats['stream_resumes']} stream resumes; "
        f"{parted} of {len(rows)} streams parted from the undisturbed run "
        f"(at bf16 near-ties); phase {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------- observability
OBS_PAIRS = 3                      # recorder off/on serve pairs


def ring_counts(rec, ring) -> dict:
    """{kind: events written to the ring plus events its rate caps
    dropped} for a ring that did not wrap and holds no torn record."""
    if ring["torn"] or rec.emitted > rec.n_slots:
        raise AssertionError(f"events ring: {ring['torn']} torn records, "
                             f"{rec.emitted} emitted into {rec.n_slots} "
                             f"slots")
    counts = dict(rec.dropped)
    for e in ring["events"]:
        counts[e["kind"]] = counts.get(e["kind"], 0) + 1
    return counts


def metric_value(inst, dep: str):
    """A serve instrument's value under ``deployment=dep`` (0 if none)."""
    return dict(inst.collect()).get((("deployment", dep),), 0)


def observability_phase(params, cfg, reqs, card) -> None:
    """The engine's observability plane on the card: (a) the port's
    flight recorder (``ray_tpu_torch._private.events``) on a fresh
    temporary directory through the 12-request GPT-2-small bf16 serve
    over K1, read back with ``read_ring`` and held to the engine's
    ``stats()``, and the port's ``serve_metrics()`` deltas held to the
    same counts; (b) the same serve with the recorder off and on,
    alternating, ``OBS_PAIRS`` pairs on fresh engines, tok/s of each
    logged (no bound: the host's speed moves between calls), and no
    ``Recorder`` built while it is off. Events and metrics are host
    numbers the driver already has: recording them adds no device
    sync."""
    import os
    import tempfile

    import torch

    from ray_tpu_torch._private import events as ev
    from ray_tpu_torch._private.metrics import serve_metrics
    from ray_tpu_torch.ops import paged_attention as pa

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    sm = serve_metrics()
    dropped = sm["events_dropped"]

    def dropped_total():
        return sum(v for _, v in dropped.collect())

    with tempfile.TemporaryDirectory(prefix="rt-events-") as evdir:
        # (a) the recorder through the serve run.
        ev._reset_for_tests()
        rec = ev.init(os.path.join(evdir, "a"), proc="chip_smoke")
        if rec is None:
            raise AssertionError("the flight recorder did not start")
        dep = "obs-a"
        d0 = dropped_total()
        pa.launches = 0
        toks, _, _, wall, st = serve(params, cfg, reqs, device=dev,
                                     attn_kernel="cuda", deployment=dep)
        launches = pa.launches
        ring = ev.read_ring(rec.path)
        counts = ring_counts(rec, ring)
        rst = rec.stats()
        ev._reset_for_tests()
        check_streams("observability", toks, reqs, cfg.vocab_size)
        log("observability: ring kinds (written + dropped) " + ", ".join(
            f"{k} {n}" for k, n in sorted(counts.items())) +
            f"; dropped {rst['dropped']}, ring fill {rst['ring_fill']}")
        want = {"engine.admit": st["admitted"],
                "engine.dispatch": st["dispatches"]}
        got = {k: counts.get(k, 0) for k in want}
        metrics = {
            "engine_dispatches": metric_value(sm["engine_dispatches"], dep),
            "engine_attn_kernel_dispatches": metric_value(
                sm["engine_attn_kernel_dispatches"], dep),
            "engine_tokens": metric_value(sm["engine_tokens"], dep),
            "engine_pages_free": metric_value(sm["engine_pages_free"], dep),
            "events_dropped": dropped_total() - d0}
        want_metrics = {
            "engine_dispatches": st["dispatches"],
            "engine_attn_kernel_dispatches": st["dispatches"],
            "engine_tokens": st["tokens"],
            "engine_pages_free": st["pages_free"],
            "events_dropped": rst["dropped_total"]}
        want_launches = cfg.n_layer * 8 * st["dispatches"]
        log(f"observability: events {got} (stats {want}); metrics "
            f"{metrics} (stats {want_metrics}); attn_kernel_dispatches "
            f"{st['attn_kernel_dispatches']}; K1 launches {launches} (want "
            f"n_layer*chunk*dispatches={want_launches})")
        if got != want or metrics != want_metrics or launches != \
                want_launches or st["attn_kernel_dispatches"] != \
                st["dispatches"]:
            raise AssertionError("observability: the recorder or the "
                                 "metrics disagree with stats()")

        # (b) what the recorder costs: off, on, alternating.
        built = [0]
        plain_recorder = ev.Recorder

        class CountedRecorder(plain_recorder):
            def __init__(self, *a, **kw):
                built[0] += 1
                super().__init__(*a, **kw)

        ev.Recorder = CountedRecorder
        rates = {"off": [], "on": []}
        try:
            for i in range(OBS_PAIRS):
                for mode in ("off", "on"):
                    ev._reset_for_tests()
                    if mode == "on":
                        ev.init(os.path.join(evdir, f"b{i}"),
                                proc="chip_smoke")
                    n_built = built[0]
                    toks, _, _, wall, _ = serve(
                        params, cfg, reqs, device=dev, attn_kernel="cuda",
                        deployment=f"obs-{mode}-{i}")
                    if mode == "off" and (built[0] != n_built
                                          or ev.recorder() is not None):
                        raise AssertionError("a Recorder was built with "
                                             "the recorder off")
                    rates[mode].append(sum(map(len, toks)) / wall)
        finally:
            ev.Recorder = plain_recorder
            ev._reset_for_tests()
    off, on = p50(rates["off"]), p50(rates["on"])
    log(f"observability cost [{card}]: recorder off "
        f"{[round(r, 2) for r in rates['off']]} tok/s, on "
        f"{[round(r, 2) for r in rates['on']]} tok/s; p50 off {off:.2f}, "
        f"on {on:.2f}, on/off {on / off:.4f} (alternating pairs, fresh "
        f"engines; {built[0]} recorders built, all with it on); phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------- batching front
BATCH_DEPLOYMENT = "gpt_continuous"
BATCH_DEADLINE_S = 600.0           # generous: the requests must not expire
BATCH_TEMPERATURE = 0.8
#: (b) benchmarks/serve_resnet.py:69-70's batcher configuration.
RESNET_SERVE_BATCH = dict(max_batch_size=16, batch_wait_timeout_s=0.005,
                          pad_to_bucket=True)
#: (b) each caller's logits against its image's row of an unbatched
#: forward, relative to that row's largest |logit|: cuDNN picks its
#: algorithm by batch size, and two bf16 runs of ~50 rounded conv/BN
#: outputs (2^-9 relative each) may part by a few percent of the range,
#: as bf16 does against f32 (RESNET_BF16_REL).
RESNET_BATCH_REL = 0.05


def _request_scope(request, deadline_s, deployment, request_id):
    """Set the request context a replica sets around user code; returns
    a function that resets it."""
    sets = [(request._request_deadline, deadline_s),
            (request._request_deployment, deployment),
            (request._request_id, request_id)]
    tokens = [(var, var.set(value)) for var, value in sets]

    def reset():
        for var, tok in reversed(tokens):
            var.reset(tok)
    return reset


def _ordered_callers(fn, items, scope, tracing):
    """One thread a request, each inside a ``request`` span and its
    request context; thread i calls ``fn`` (which enqueues) only after
    thread i-1 did, so the engine admits in request order as ``serve``
    does. Returns (threads, the event set once every call enqueued,
    results: i -> (span context, tokens or the exception, chunk
    stamps))."""
    import numpy as np

    turn = [threading.Event() for _ in range(len(items) + 1)]
    turn[0].set()
    out = {}

    def run(i):
        turn[i].wait()
        reset = scope(i)
        try:
            with tracing.span("request") as sp:
                try:
                    stream = fn(items[i])
                finally:
                    turn[i + 1].set()
                pieces, stamps = [], []
                try:
                    for piece in stream:
                        stamps.append(time.perf_counter())
                        pieces.append(piece)
                    out[i] = (sp, np.concatenate(pieces), stamps)
                except Exception as e:  # noqa: BLE001 - held by the phase
                    out[i] = (sp, e, stamps)
        finally:
            reset()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(items))]
    for t in threads:
        t.start()
    return threads, turn[-1], out


def _join(threads, what):
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"batching ({what}): callers did not finish "
                           f"within 600 s")


def batching_phase(params, cfg, reqs, toks, card, greedy_tok_s=None) -> None:
    """The serving front's request batcher (``ray_tpu_torch.serve.batching``)
    and the engine's trace spans (``ray_tpu_torch.util.tracing``) on the
    card, tracing on:

    (a) the 12 serving requests from 12 caller threads through a class
    whose method carries ``@batch(continuous=True)`` over a K1 engine
    (deployment ``gpt_continuous``), each caller inside a ``request``
    span with a deadline, deployment and request id set as a replica
    sets them: the streams equal the direct greedy K1 streams ``toks``,
    one ``engine.admission`` span a request under its ``request`` span,
    each request's ``decode.chunk`` tokens add up to its stream after
    the first, K1 launched ``n_layer * chunk`` times a dispatch, no span
    dropped;
    (b) ResNet-50 (full width, bf16, seed-0 weights) behind
    ``@batch(max_batch_size=16, batch_wait_timeout_s=0.005,
    pad_to_bucket=True)`` (``benchmarks/serve_resnet.py:69-70``), 16
    concurrent callers, twice (the flusher thread's first CUDA work, then
    steady state), each round: the handler sees only sizes in
    ``default_buckets(16)``, each caller's logits match its image's row
    of an unbatched forward within ``RESNET_BATCH_REL``, one
    ``batch.wait`` span a caller, ``serve_batch_size`` observed once a
    flush;
    (c) the 12 requests at seeded T=0.8 through the same wrapper, equal
    to a direct ``serve`` with the same seeds, plus one request whose
    deadline has passed: it raises ``RequestDeadlineExceeded`` and is
    counted once under ``requests_expired{where="engine"}``."""
    import numpy as np
    import torch

    from ray_tpu_torch._private.metrics import serve_metrics
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve import batching, request
    from ray_tpu_torch.serve.engine import DecodeEngine
    from ray_tpu_torch.util import tracing

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    sm = serve_metrics()
    kw = dict(slots=16, chunk=8, max_len=1024, page_size=16,
              attn_kernel="cuda", device=dev, auto_start=False)
    greedy = DecodeEngine(params, cfg, deployment=BATCH_DEPLOYMENT, **kw)
    sampled = DecodeEngine(params, cfg, temperature=BATCH_TEMPERATURE,
                           deployment=BATCH_DEPLOYMENT + "_t08", **kw)

    class GPTDeployment:
        """A deployment's decode method: per request, the engine and its
        submit keywords; the wrapper submits under the request's
        context."""

        engines = {"greedy": greedy, "sampled": sampled}

        @batching.batch(continuous=True, page_size=16, attn_kernel="cuda")
        def decode(self, req):
            return self.engines[req["engine"]], {
                "prompt": req["prompt"], "max_new": req["max_new"],
                "seed": req["seed"]}

    gpt_dep = GPTDeployment()
    tracing.drain()
    dropped0 = tracing.dropped_total()
    tracing.enable()
    try:
        # (a) greedy through @batch(continuous=True)
        items = [{"engine": "greedy", "prompt": p, "max_new": m, "seed": 0}
                 for p, m in reqs]
        deadline = request.make_deadline(BATCH_DEADLINE_S)
        threads, queued, out = _ordered_callers(
            gpt_dep.decode, items, lambda i: _request_scope(
                request, deadline, BATCH_DEPLOYMENT, f"rq-batch-{i}"),
            tracing)
        if not queued.wait(120):
            raise TimeoutError("batching (a): the callers did not enqueue")
        pa.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy.start()
        _join(threads, "a")
        wall = time.perf_counter() - t0
        launches = pa.launches
        st = greedy.stats()
        spans = tracing.drain()
        got = [out[i][1] for i in range(len(reqs))]
        for i, g in enumerate(got):
            if isinstance(g, Exception):
                raise AssertionError(f"batching (a): request {i} failed: "
                                     f"{g!r}")
        check_streams("batching (a)", got, reqs, cfg.vocab_size)
        same = [np_equal(g, t) for g, t in zip(got, toks)]
        by_name = {}
        for s in spans:
            by_name[s["name"]] = by_name.get(s["name"], 0) + 1
        per_req = []
        for i in range(len(reqs)):
            sid = out[i][0]["span_id"]
            mine = [s for s in spans if s["parent_id"] == sid]
            per_req.append((
                sum(s["name"] == "engine.admission" for s in mine),
                sum(s["attrs"]["tokens"] for s in mine
                    if s["name"] == "decode.chunk")))
        want_launches = cfg.n_layer * 8 * st["dispatches"]
        n_tok = sum(map(len, got))
        rate = n_tok / wall
        log(f"batching (a) @batch(continuous=True) -> K1 engine "
            f"'{BATCH_DEPLOYMENT}' [{card}]: {len(reqs)} caller threads, "
            f"streams equal to the direct greedy K1 streams: {sum(same)} of "
            f"{len(same)}; spans by name {by_name}; engine.admission and "
            f"decode.chunk tokens a request {per_req}; dispatches "
            f"{st['dispatches']}, K1 launches {launches} (want n_layer*chunk"
            f"*dispatches={want_launches}); {n_tok} tokens in {wall:.4f} s = "
            f"{rate:.2f} tok/s (the direct greedy serve "
            f"{greedy_tok_s if greedy_tok_s is None else round(greedy_tok_s, 2)}"
            f" tok/s; host-bound, not gated); spans dropped "
            f"{tracing.dropped_total() - dropped0}")
        if not all(same):
            raise AssertionError("batching (a): streams through @batch "
                                 "differ from the direct greedy streams")
        if any(a != 1 for a, _ in per_req) or any(
                n != len(t) - 1 for (_, n), t in zip(per_req, got)):
            raise AssertionError("batching (a): engine.admission or "
                                 "decode.chunk spans wrong: " + str(per_req))
        if by_name.get("request") != len(reqs):
            raise AssertionError(f"batching (a): {by_name}")
        if launches != want_launches or launches == 0:
            raise AssertionError("batching (a): K1 did not run on every "
                                 "decode step")
        if tracing.dropped_total() != dropped0:
            raise AssertionError("batching (a): spans were dropped")

        # (c) seeded T=0.8 through the same wrapper, plus an expired
        # request
        seeds = list(range(len(reqs)))
        want, *_ = serve(params, cfg, reqs, device=dev, attn_kernel="cuda",
                         seeds=seeds, temperature=BATCH_TEMPERATURE)
        items = [{"engine": "sampled", "prompt": p, "max_new": m,
                  "seed": s} for (p, m), s in zip(reqs, seeds)]
        items.append(dict(items[0], seed=99))
        n = len(reqs)
        dep_c = BATCH_DEPLOYMENT + "_t08"
        expired_key = (("deployment", dep_c), ("where", "engine"))
        e0 = dict(sm["requests_expired"].collect()).get(expired_key, 0)
        deadlines = [request.make_deadline(BATCH_DEADLINE_S)] * n + [
            request.make_deadline(-1.0)]
        threads, queued, out = _ordered_callers(
            gpt_dep.decode, items, lambda i: _request_scope(
                request, deadlines[i], dep_c, f"rq-batch-t08-{i}"), tracing)
        if not queued.wait(120):
            raise TimeoutError("batching (c): the callers did not enqueue")
        sampled.start()
        _join(threads, "c")
        expired = dict(sm["requests_expired"].collect()).get(
            expired_key, 0) - e0
        stc = sampled.stats()
        tracing.drain()
        got = [out[i][1] for i in range(n)]
        last = out[n][1]
        same = [not isinstance(g, Exception) and np_equal(g, w)
                for g, w in zip(got, want)]
        log(f"batching (c) seeded T={BATCH_TEMPERATURE} through the same "
            f"wrapper [{card}]: {sum(same)} of {n} streams equal to the "
            f"direct serve with the same seeds; the request past its "
            f"deadline raised {type(last).__name__}; requests_expired"
            f"{{where=engine}} +{expired}, stats expired {stc['expired']}")
        if not all(same):
            raise AssertionError("batching (c): seeded streams through "
                                 "@batch differ from the direct serve")
        if not isinstance(last, request.RequestDeadlineExceeded) or \
                expired != 1 or stc["expired"] != 1:
            raise AssertionError("batching (c): the expired request was "
                                 "not failed and counted once")
    finally:
        greedy.shutdown()
        sampled.shutdown()

    # (b) ResNet-50 bf16 behind the bucketed batcher
    try:
        t_rn = time.perf_counter()
        rcfg = resnet.ResNetConfig(depth=50)
        rparams = resnet.init_params(rcfg, 0, device=dev)
        predict = resnet.make_predictor(rcfg, rparams)
        buckets = batching.default_buckets(
            RESNET_SERVE_BATCH["max_batch_size"])
        rng = np.random.default_rng(17)
        n_img = RESNET_SERVE_BATCH["max_batch_size"]
        imgs = rng.standard_normal((n_img, 224, 224, 3)).astype(np.float32)
        for b in buckets:             # warm every bucket (cuDNN plans)
            predict(imgs[:b]).cpu()
        alone = [predict(imgs[i:i + 1]).float().cpu()[0]
                 for i in range(n_img)]

        class ResNetDeployment:
            def __init__(self):
                self.sizes = []

            @batching.batch(**RESNET_SERVE_BATCH)
            def run_batch(self, images):
                self.sizes.append(len(images))
                return list(predict(np.stack(images)).float().cpu())

        rn = ResNetDeployment()
        dep_b = "resnet50"
        key = (("deployment", dep_b),)
        rdeadline = request.make_deadline(BATCH_DEADLINE_S)

        def round_(r):
            """16 concurrent callers, each in its ``request`` span."""
            res, lat = {}, {}
            start = threading.Event()

            def call(i):
                reset = _request_scope(request, rdeadline, dep_b,
                                       f"rq-rn-{r}-{i}")
                try:
                    start.wait()
                    with tracing.span("request") as sp:
                        t = time.perf_counter()
                        res[i] = (sp, rn.run_batch(imgs[i]))
                        lat[i] = time.perf_counter() - t
                finally:
                    reset()

            threads = [threading.Thread(target=call, args=(i,),
                                        daemon=True) for i in range(n_img)]
            for t in threads:
                t.start()
            start.set()
            _join(threads, "b")
            return res, lat

        # Round 0 is the flusher thread's first CUDA work (its own
        # cuBLAS/cuDNN handles); round 1 is steady state.
        for r in range(2):
            before = dict(sm["batch_size"].collect()).get(key)
            n0 = before[-1] if before else 0
            flushes0 = len(rn.sizes)
            res, lat = round_(r)
            bq = rn.__dict__["__rt_batch_queue_run_batch"]
            sizes, pre = rn.sizes[flushes0:], bq.batch_sizes[flushes0:]
            spans = tracing.drain()
            after = dict(sm["batch_size"].collect()).get(key)
            flushes_seen = (after[-1] if after else 0) - n0
            errs = [float((res[i][1] - alone[i]).abs().max()
                          / alone[i].abs().max()) for i in range(n_img)]
            waits = {}
            for s in spans:
                if s["name"] == "batch.wait":
                    waits[s["parent_id"]] = waits.get(s["parent_id"], 0) + 1
            one_wait = all(waits.get(res[i][0]["span_id"]) == 1
                           for i in range(n_img))
            log(f"batching (b) round {r}: ResNet-50 bf16 behind @batch"
                f"({RESNET_SERVE_BATCH}) [{card}]: {n_img} callers; "
                f"handler batch sizes {sizes} (pre-pad {pre}; buckets "
                f"{buckets}); logits vs the unbatched forward, max |diff| "
                f"/ max |row|: worst {max(errs):.4g} (tolerance "
                f"{RESNET_BATCH_REL}); batch.wait spans "
                f"{sum(waits.values())}, one a caller: {one_wait}; "
                f"serve_batch_size observations {flushes_seen} for "
                f"{len(pre)} flushes; caller latency p50 "
                f"{p50(list(lat.values())) * 1e3:.3f} ms, max "
                f"{max(lat.values()) * 1e3:.3f} ms")
            if not set(sizes) <= set(buckets) or sum(pre) != n_img:
                raise AssertionError("batching (b): the handler saw a size "
                                     "outside the buckets")
            if not max(errs) <= RESNET_BATCH_REL:
                raise AssertionError("batching (b): batched logits differ "
                                     "from the unbatched forward")
            if not one_wait or flushes_seen != len(pre):
                raise AssertionError("batching (b): batch.wait spans or "
                                     "serve_batch_size observations wrong")
        log(f"batching (b): {time.perf_counter() - t_rn:.1f} s with the "
            f"weights' draw")
        if tracing.dropped_total() != dropped0:
            raise AssertionError("batching: spans were dropped")
        del rparams, predict
    finally:
        tracing.disable()
        tracing.drain()
    torch.cuda.empty_cache()
    log(f"batching phase: {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------- MoE
#: The MoE model on the card: the repo's GPT-2 small with 8 experts and
#: the reference's own MoE defaults (top-2, capacity factor 1.25, aux
#: weight 0.01), built with ``dataclasses.replace`` as the reference's
#: tests build theirs (Mixtral-8x7B's routing shape at GPT-2-small width).
MOE_EXPERTS = 8
#: The CPU tests' drop-forcing pool (``tests/test_torch_moe_engine.py``),
#: nano with 4 experts: 14 requests for 12 slots at capacity factor 0.25,
#: so every expert holds 8 pairs and overflows while finished slots sit,
#: inactive, before active ones.
NANO_MOE_EXPERTS = 4
MOE_LENS = [5, 9, 3, 12, 7, 16, 4, 11, 6, 14, 8, 10, 13, 5]
MOE_MAX_NEWS = [3, 5, 2, 6, 20, 24, 18, 22, 19, 21, 23, 20, 17, 16]
MOE_SEEDS = [3, 0, 7, 2 ** 31 - 1, -3, 11, 5, 8, 9, 1, 2, 4, 6, 10]
MOE_NANO_KW = dict(slots=12, chunk=4, max_len=64, page_size=8,
                   prompt_buckets=(8, 16))
# The MoE bf16 gate (``moe_gate``). In an MoE pool the experts' capacity
# is shared by every row, so a stream can part where a rounding flip
# changed a route in any row at any earlier step, not only at a near-tie
# of its own final logits, and a forward of one request alone
# (``tie_ratios``) does not compute what the pool computed. Nor do the
# streams stay comparable after the pool's first parting. So the gate
# replays the gather engine's own device calls, teacher-forced with the
# tokens it fed (``replay``): in bf16 through the gather version (which
# must reproduce the gather engine token for token), in f32 along those
# bf16 routes, and in bf16 through K1 along the same routes, recording
# the route K1's arithmetic would take at every MoE call and the token
# it would take at every decode step. Forcing the routes keeps the K1
# replay one rounding away from the gather replay over the whole run, so
# EVERY decision is held, not only the first parting:
# - each route K1 would flip must join two experts within ROUTE_ERRS *
#   eps of each other in the f32 router probabilities, eps being the
#   call's largest bf16-vs-f32 probability error (each bf16 path sits
#   within about eps of f32, so a rounding flip needs a margin within
#   their sum); each token it would flip must have both tokens within
#   TIE_ERRS * eps of the top of the f32 logits, eps the step's largest
#   bf16-vs-f32 logit error, as the dense gate holds it;
# - every K1 call of the run must lie within ATTN_ULPS bf16 ulps of its
#   plain version on the same inputs (in units of 2**-8 of the call's
#   largest output).
# On an H100 80GB HBM3 at 700 W over 3 draws (PERF.md; the divergence
# script with --moe) a correct K1 flipped 71-91 routes and 9-15 tokens
# per run, each within 0.75-0.84 of its bound, and lay 2.20-2.47 ulps
# from its plain version; with K1's output 3 % too large (``scale``) the
# worst flip sat at 2.61-2.72 and K1 9.3-10.2 ulps off, one position
# short (``pos-1``) at 20-58 and 200-303 ulps. A per-row eps instead put
# a correct K1's worst route flip at 3.46: eight probabilities are too
# few for a row's largest error to bound the other path's.
ROUTE_ERRS = 2.0
ATTN_ULPS = 4


class CallLog:
    """While active, records every paged prefill and decode chunk a new
    engine makes (``gpt_decode.prefill_into_slot_paged`` /
    ``decode_chunk_slots_paged``): arguments copied at the call, and each
    chunk's tokens, so that :func:`replay` can run the same calls again."""

    def __enter__(self):
        import numpy as np

        from ray_tpu_torch.models import gpt_decode as gd

        self.calls, self.pool = [], None
        self._saved = pre, chunk = (gd.prefill_into_slot_paged,
                                    gd.decode_chunk_slots_paged)

        def prefill(params, cache, *args, **kw):
            self.calls.append(("prefill", tuple(np.array(a, copy=True)
                                                for a in args), kw))
            return pre(params, cache, *args, **kw)

        def decode(params, cache, token, rngs, active, **kw):
            out = chunk(params, cache, token, rngs, active, **kw)
            self.pool = (cache["pos"].shape[0], cache["k"].shape[1],
                         kw["page_size"], kw["kv_dtype"])
            self.calls.append(("chunk", (np.array(token, np.int32),
                                         np.array(active, bool),
                                         np.array(kw["pt"])), kw,
                               out[0].copy()))
            return out

        gd.prefill_into_slot_paged, gd.decode_chunk_slots_paged = \
            prefill, decode
        return self

    def __exit__(self, *exc):
        from ray_tpu_torch.models import gpt_decode as gd

        gd.prefill_into_slot_paged, gd.decode_chunk_slots_paged = \
            self._saved


def replay(clog, params, cfg, kernel, *, force=None, k1=None):
    """Run ``clog``'s calls again on a fresh pool of the same kind (fp or
    int8): each prefill with
    its recorded arguments, each chunk one step at a time fed the tokens
    the recorded engine fed (teacher-forced), attention by ``kernel``
    (``"cuda"``: K1, or ``k1`` standing in for it, e.g. with a fault).
    ``force`` (one ``Routes`` per MoE call) imposes those routes, with
    gates from this run's probabilities. Returns (per MoE call: (decode
    step index, probs, the routes this run's probabilities pick), per
    decode step: (active, the fed token, f32 logits), whether every
    attention output was finite, and the largest gap between a K1 call's
    output and its plain version's on the same inputs, relative to that
    call's largest plain output)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt_decode as gd
    from ray_tpu_torch.models import moe

    dev = torch.device("cuda")
    slots, n_pages, ps, kv = clog.pool
    cache = gd.init_paged_cache(cfg, slots, n_pages, ps, kv, dev)
    calls, steps = [], []
    finite = torch.ones((), dtype=torch.bool, device=dev)
    worst = torch.zeros((), dtype=torch.float32, device=dev)
    route, attend = moe.route, gd.paged_attention_cuda

    def rec(probs, top_k, cap):
        own = route(probs, top_k, cap)
        calls.append((len(steps), probs.detach(), own))
        if force is None:
            return own
        f = force[len(calls) - 1]
        g = probs.gather(1, f.expert.t())
        g = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
        return moe.Routes(f.expert, f.slot, f.keep, g.t())

    def k1_checked(*a, **kw):
        out = (k1 or attend)(*a, **kw)
        finite.logical_and_(torch.isfinite(out).all())
        plain = gd._paged_attention_gather(*a, **kw).float()
        torch.maximum(worst, (out.float() - plain).abs().max()
                      / plain.abs().max().clamp_min(1e-30), out=worst)
        return out

    moe.route, gd.paged_attention_cuda = rec, k1_checked
    try:
        with torch.no_grad():
            for call in clog.calls:
                if call[0] == "prefill":
                    gd.prefill_into_slot_paged(params, cache, *call[1],
                                               **dict(call[2], cfg=cfg))
                    continue
                (token, active, pt), out = call[1], call[3]
                pos = cache["pos"].cpu().numpy().astype(np.int64)
                tok = token
                for s in range(out.shape[1]):
                    logits = gd._slot_decode_step_paged(
                        params, cache, torch.from_numpy(tok).to(dev),
                        active, pt, pos, cfg, ps, kv, kernel)
                    pos = pos + active
                    tok = np.ascontiguousarray(out[:, s])
                    steps.append((active, tok, logits))
    finally:
        moe.route, gd.paged_attention_cuda = route, attend
    return calls, steps, bool(finite), float(worst)


def moe_gate(got, ref, got_log, ref_log, params, cfg, k1=None):
    """Hold the bf16 MoE kernel engine's streams (``got``, its calls
    ``got_log``) against the gather engine's (``ref``, ``ref_log``):
    identical up to the pool's first parting, and every decision K1's
    arithmetic would flip along the replayed gather run a rounding
    near-tie, K1 within ``ATTN_ULPS`` of its plain version (the bounds
    above). ``k1`` stands in for K1 in the replay as it did in the kernel
    engine (an injected fault). The gather and f32 replays are kept on
    ``ref_log`` for the next call. Returns (passed, what was found)."""
    import dataclasses

    import numpy as np
    import torch

    if not parting_steps(got, ref):
        return True, "no stream parted"
    first, t = None, 0
    for i, (a, b) in enumerate(zip(ref_log.calls, got_log.calls)):
        if a[0] != b[0]:
            return False, f"call {i}: the engines made different calls"
        if a[0] == "prefill":
            continue
        if not (np_equal(a[1][0], b[1][0]) and np_equal(a[1][1], b[1][1])):
            return False, f"call {i}: the engines' inputs differ"
        diff = ((a[3] != b[3]) & a[1][1][:, None]).any(0)
        if diff.any():
            first = t + int(diff.argmax())
            break
        t += a[3].shape[1]
    if first is None:
        return False, "the streams part but no decode call's tokens differ"
    if not hasattr(ref_log, "base"):
        A, A_steps, *_ = replay(ref_log, params, cfg, "gather")
        for j, (_, tok, lg) in enumerate(A_steps):
            if not np_equal(lg.argmax(-1).cpu().numpy(), tok):
                return False, (f"the gather replay does not reproduce the "
                               f"gather engine at decode step {j}")
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        F, F_steps, *_ = replay(ref_log, {k: v.float() for k, v in
                                          params.items()}, c32, "gather",
                                force=[r for _, _, r in A])
        ref_log.base = A, A_steps, F, F_steps
    A, A_steps, F, F_steps = ref_log.base
    K, K_steps, finite, attn = replay(ref_log, params, cfg, "cuda",
                                      force=[r for _, _, r in A], k1=k1)
    if not finite:
        return False, "K1 gave a non-finite attention output"
    noise = {"route": 0.0, "logit": 0.0}
    flips = []                     # (decode step, kind, distance from tie)
    for (step, pa_, ra), (_, pf, _), (_, pk, rk) in zip(A, F, K):
        eps, gap = (float((x - pa_).abs().max()) for x in (pf, pk))
        if not gap:
            continue
        noise["route"] = max(noise["route"], gap / eps if eps else math.inf)
        for r in (ra.expert != rk.expert).any(0).nonzero()[:, 0].tolist():
            j = int((ra.expert[:, r] != rk.expert[:, r]).int().argmax())
            ea, ek = int(ra.expert[j, r]), int(rk.expert[j, r])
            margin = abs(float(pf[r, ea] - pf[r, ek]))
            flips.append((step, "route", margin / (ROUTE_ERRS * eps)))
    for j, ((act, tok, la), (_, _, lf), (_, _, lk)) in enumerate(
            zip(A_steps, F_steps, K_steps)):
        rows = torch.from_numpy(np.flatnonzero(act)).to(la.device)
        eps, gap = (float((x[rows] - la[rows]).abs().max())
                    for x in (lf, lk))
        if gap:
            noise["logit"] = max(noise["logit"],
                                 gap / eps if eps else math.inf)
        mine = lk.argmax(-1).cpu().numpy()
        for r in np.flatnonzero(act & (mine != tok)).tolist():
            L = lf[r]
            top = float(L.max() - torch.minimum(L[int(tok[r])],
                                                L[int(mine[r])]))
            flips.append((j, "token", top / (TIE_ERRS * eps)))
    if not flips or min(f[0] for f in flips) > first:
        return False, (f"the K1 replay flips nothing before the engines' "
                       f"first parting (decode step {first})")
    worst = max(flips, key=lambda f: f[2])
    n_route = sum(f[1] == "route" for f in flips)
    ulps = attn / 2.0 ** -8
    return worst[2] <= 1 and ulps <= ATTN_ULPS, (
        f"first parting at decode step {first} of {len(A_steps)}; along "
        f"the gather run K1 flips {n_route} routes (of {len(A)} MoE calls)"
        f" and {len(flips) - n_route} tokens, the first at step "
        f"{min(f[0] for f in flips)}, the farthest from a tie at "
        f"{worst[2]:.4f} of its bound ({worst[1]} at step {worst[0]}; "
        f"bound 1); K1 within {ulps:.3f} bf16 ulps of its plain version "
        f"(bound {ATTN_ULPS}); K1-vs-gather router probabilities and "
        f"logits {noise['route']:.3f} and {noise['logit']:.3f} times the "
        f"gather path's own bf16-vs-f32 error (not bounded)")


def moe_nano_phase(card) -> None:
    """Nano MoE on the card: ``init_params`` bit-equal to the CPU's, and
    f32 streams served through K1 equal to the CPU's through the plain
    version, on the CPU tests' drop-forcing pool (capacity factor 0.25)
    at T=0 and T=0.8 and with every pair kept (1.25) at T=0."""
    import dataclasses

    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import paged_attention as pa

    base = dataclasses.replace(gpt.CONFIGS["nano"],
                               n_experts=NANO_MOE_EXPERTS)
    p_cpu = gpt.init_params(base, seed=0, device="cpu")
    p_card = gpt.init_params(base, seed=0, device="cuda")
    if not all(torch.equal(p_card[k].cpu().view(torch.int32),
                           v.view(torch.int32)) for k, v in p_cpu.items()):
        raise AssertionError("init_params(nano MoE): the card's draw "
                             "differs from the CPU's")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, base.vocab_size, (n,)).astype(np.int32), m)
            for n, m in zip(MOE_LENS, MOE_MAX_NEWS)]
    for cf, temp in ((0.25, 0.0), (0.25, 0.8), (1.25, 0.0)):
        cfg = dataclasses.replace(base, dtype=torch.float32,
                                  capacity_factor=cf)
        kw = dict(MOE_NANO_KW, temperature=temp,
                  seeds=MOE_SEEDS if temp else None)
        ref, *_ = serve(p_cpu, cfg, reqs, device=torch.device("cpu"),
                        attn_kernel="gather", **kw)
        pa.launches = 0
        got, _, _, _, st = serve(p_cpu, cfg, reqs,
                                 device=torch.device("cuda"),
                                 attn_kernel="cuda", **kw)
        want = cfg.n_layer * MOE_NANO_KW["chunk"] * st["dispatches"]
        if pa.launches != want or not pa.launches:
            raise AssertionError(f"nano MoE: K1 launches {pa.launches}, "
                                 f"want {want}")
        if not all(np_equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"nano MoE f32 cf={cf} T={temp}: card "
                                 f"streams differ from the CPU's")
    log(f"nano MoE (4 experts, top-2) [{card}]: init_params card "
        f"bit-equal to CPU; f32 K1 streams == CPU plain streams, "
        f"{len(reqs)} requests in 12 slots, capacity factor 0.25 at T=0 "
        f"and T=0.8, 1.25 at T=0")


def moe_serve_phase(reqs, dense, card) -> None:
    """GPT-2 small with 8 experts (bf16, the reference's draw for seed 0,
    timed) serving the 12 requests through ``DecodeEngine(slots=16,
    chunk=8, max_len=1024, page_size=16, attn_kernel="cuda")``: every
    stream completes, K1 runs ``n_layer * chunk`` times per dispatch, the
    streams pass the MoE bf16 gate against the gather engine, and both
    injected K1 faults fail it; an int8 pool (the same gate) and
    f32 (kernel vs gather within ``MAX_DIVERGED["f32"]``); an n-gram spec
    engine; a paged→paged fp handoff equal to the colocated kernel
    engine; TTFT/TPOT/tok/s beside the dense engine's (``dense``); a
    profiled window."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models import gpt_decode as gd
    from ray_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    cfg = dataclasses.replace(gpt.CONFIGS["small"], n_experts=MOE_EXPERTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"init_params GPT-2 small MoE ({MOE_EXPERTS} experts, top-"
        f"{cfg.expert_top_k}; the reference's draw for seed 0, bf16 "
        f"storage) on the card [{card}]: {time.perf_counter() - t0:.3f} s "
        f"for {sum(p.numel() for p in params.values())} weights")
    serve(params, cfg, reqs[:2], device=dev, attn_kernel="gather")
    with CallLog() as ref_log:
        ref, *_ = serve(params, cfg, reqs, device=dev, attn_kernel="gather")
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    with CallLog() as got_log:
        toks, ttft, tpot, wall, st = serve(params, cfg, reqs, device=dev,
                                           attn_kernel="cuda")
    launches, peak = pa.launches, torch.cuda.max_memory_allocated()
    check_streams("small MoE bf16", toks, reqs, cfg.vocab_size)
    want = cfg.n_layer * 8 * st["dispatches"]
    if st["completed"] != len(reqs) or launches != want or not launches:
        raise AssertionError(f"MoE engine: completed {st['completed']}, "
                             f"K1 launches {launches} (want {want})")
    n = sum(map(len, toks))
    d_toks, d_ttft, d_tpot, d_wall = dense
    log(f"small MoE bf16 engine [{card}]: {n} tokens in {wall:.4f} s = "
        f"{n / wall:.2f} tok/s (dense {sum(map(len, d_toks)) / d_wall:.2f});"
        f" TTFT p50 {p50(ttft) * 1e3:.3f} ms (dense "
        f"{p50(d_ttft) * 1e3:.3f}); TPOT p50 {p50(tpot) * 1e3:.3f} ms "
        f"(dense {p50(d_tpot) * 1e3:.3f}); K1 launches {launches} = "
        f"n_layer*chunk*{st['dispatches']} dispatches; peak memory "
        f"{peak / 2**20:.1f} MiB")
    ok, why = moe_gate(toks, ref, got_log, ref_log, params, cfg)
    log(f"small MoE bf16: kernel vs gather: "
        f"{len(parting_steps(toks, ref))}/{len(reqs)} streams part; {why}")
    if not ok:
        raise AssertionError("small MoE bf16: K1 is more than a rounding "
                             "away from the gather version")
    for fault in ("pos-1", "scale"):
        k1 = faulty_k1(fault)
        gd.paged_attention_cuda = k1
        try:
            with CallLog() as bad_log:
                bad, *_ = serve(params, cfg, reqs, device=dev,
                                attn_kernel="cuda")
        finally:
            gd.paged_attention_cuda = pa.paged_attention_cuda
        ok, why = moe_gate(bad, ref, bad_log, ref_log, params, cfg, k1=k1)
        log(f"small MoE bf16, K1 fault {fault!r} injected: "
            f"{len(parting_steps(bad, ref))}/{len(reqs)} streams part; "
            f"{why}; gate {'PASSED' if ok else 'failed'}")
        if ok:
            raise AssertionError(f"the MoE bf16 gate passed K1 with the "
                                 f"{fault!r} fault")

    reqs32 = [(p, 32) for p, _ in reqs]
    with CallLog() as ref_log8:
        ref8, *_ = serve(params, cfg, reqs32, device=dev,
                         attn_kernel="gather", kv_dtype="int8")
    pa.launches = 0
    with CallLog() as got_log8:
        toks8, _, tpot8, wall8, st8 = serve(params, cfg, reqs32, device=dev,
                                            attn_kernel="cuda",
                                            kv_dtype="int8")
    launches8, want8 = pa.launches, cfg.n_layer * 8 * st8["dispatches"]
    check_streams("small MoE int8", toks8, reqs32, cfg.vocab_size)
    if st8["completed"] != len(reqs32) or launches8 != want8:
        raise AssertionError(f"MoE int8: completed {st8['completed']}, K1 "
                             f"launches {launches8} (want {want8})")
    # A count of parted streams does not fit an MoE pool (one flip parts
    # them all): the int8 pools are held by the same gate, the f32
    # replay on an int8 pool too, so a code that a rounding moved across
    # an int8 boundary counts in both paths' errors.
    ok, why = moe_gate(toks8, ref8, got_log8, ref_log8, params, cfg)
    log(f"small MoE int8: kernel vs gather: "
        f"{len(parting_steps(toks8, ref8))}/{len(reqs32)} streams part; "
        f"{why}")
    if not ok:
        raise AssertionError("small MoE int8: K1 is more than a rounding "
                             "away from the gather version")
    log(f"small MoE int8 engine [{card}]: "
        f"{sum(map(len, toks8)) / wall8:.2f} tok/s; TPOT p50 "
        f"{p50(tpot8) * 1e3:.3f} ms; K1 launches {launches8}")

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = gpt.init_params(cfg32, seed=0, device=dev)
    for kv in ("fp", "int8"):
        ref32, *_ = serve(params32, cfg32, reqs32, device=dev,
                          attn_kernel="gather", kv_dtype=kv)
        pa.launches = 0
        toks32, _, tpot32, wall32, st32 = serve(
            params32, cfg32, reqs32, device=dev, attn_kernel="cuda",
            kv_dtype=kv)
        if pa.launches != cfg.n_layer * 8 * st32["dispatches"]:
            raise AssertionError(f"MoE f32 {kv}: K1 launches {pa.launches}")
        check_streams(f"small MoE f32 {kv}", toks32, reqs32, cfg.vocab_size)
        compare(f"small MoE f32 {kv}", toks32, ref32, "f32")
        log(f"small MoE f32 {kv} engine [{card}]: "
            f"{sum(map(len, toks32)) / wall32:.2f} tok/s; TPOT p50 "
            f"{p50(tpot32) * 1e3:.3f} ms")
    del params32
    torch.cuda.empty_cache()

    spec, _, tpot_s, wall_s, sts = serve(params, cfg, reqs, device=dev,
                                         attn_kernel="cuda",
                                         spec_decode="ngram", draft_k=4)
    check_streams("small MoE spec ngram", spec, reqs, cfg.vocab_size)
    sp = sts["spec"]
    if sts["completed"] != len(reqs) or not sp["rounds"]:
        raise AssertionError(f"MoE spec engine: {sts}")
    log(f"small MoE bf16 spec ngram [{card}]: acceptance "
        f"{sp['acceptance_rate']:.4f}, {sp['rounds']} rounds; TPOT p50 "
        f"{p50(tpot_s) * 1e3:.3f} ms; {sum(map(len, spec)) / wall_s:.2f} "
        f"tok/s; {len(parting_steps(spec, toks))}/{len(reqs)} streams "
        f"differ from the plain kernel engine's (verify routes 16 x 5 "
        f"rows at once, decode 16)")

    descs, _ = handoffs(params, cfg, reqs, device=dev, attn_kernel="cuda")
    pa.launches = 0
    hand, _, _, _, sth = serve(params, cfg, reqs, device=dev, descs=descs,
                               role="decode", attn_kernel="cuda")
    ho = sth["handoff"]
    if ho["imported"] != len(reqs) or ho["import_fallbacks"] or \
            pa.launches != cfg.n_layer * 8 * sth["dispatches"]:
        raise AssertionError(f"MoE handoff: {ho}, K1 launches "
                             f"{pa.launches}")
    if not all(np_equal(a, b) for a, b in zip(hand, toks)):
        raise AssertionError("MoE handoff: streams differ from the "
                             "colocated kernel engine's")
    log(f"small MoE bf16 handoff paged->paged fp [{card}]: {len(reqs)} "
        f"streams == colocated kernel engine; K1 launches {pa.launches}")
    profile_phase(params, cfg, [(p, 32) for p, _ in reqs[:6]], card,
                  "moe profile")
    del params
    torch.cuda.empty_cache()


def faulty_k1(fault: str):
    """K1's wrapper with ``fault`` injected: ``"pos-1"``, every slot
    attends one position short (misses its newest key); ``"scale"``, K1's
    output times ``1 + 2**-5``."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    def wrapper(q, kc, vc, pt, pos, page_size, ks=None, vs=None):
        if fault == "pos-1":
            pos = torch.where(pos > 0, pos - 1, pos)
        out = pa.paged_attention_cuda(q, kc, vc, pt, pos, page_size, ks, vs)
        return out * (1 + 2 ** -5) if fault == "scale" else out
    return wrapper


TP = 2


def tp_phase(params, cfg, reqs, greedy, reqs32, greedy8, f32_args,
             card) -> dict:
    """Tensor-parallel decode at GPT-2-small width: ``DecodeEngine(tp=2)``
    over a group of two ranks on this one card, gloo (NCCL refuses two
    ranks on one GPU): this process is rank 0, a follower process rank
    1, each holding half the heads (K1 at H=6) and half the FFN, their
    row-parallel partials summed by all-reduce. Against the tp=1 K1
    engines of the same weights: bf16 (the 12 requests) parts at bf16
    near-ties only, int8 (32 new tokens) within its count budget, f32 fp
    within ``MAX_DIVERGED["f32"]``; first tokens may part too, since the
    prefills sum in another order. A tp=2 prefill-role engine hands the
    requests off to a tp=1 decode-role K1 engine (f32), whose streams
    must equal the colocated tp=1 engine's, every one. K1 launches
    ``n_layer * chunk`` times a dispatch on each rank, bf16 and int8
    pools alike (counted on both ranks); 2 * n_layer all-reduces a step
    on rank 0 (counted). K1 at the rank's shape (H=6), bf16 and int8
    pools, against its plain version. TTFT/TPOT and one all-reduce's
    host ms are printed: two processes sharing ONE card, every
    collective staged through host memory by gloo, not a figure for
    tensor parallelism across cards. Returns K1's two H=6 records."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch._private import events as ev
    from ray_tpu_torch._private import tp
    from ray_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    group = tp.decode_group(TP, devices=("cuda:0",) * TP, backend="gloo")
    try:
        log(f"tp: {TP} ranks on {group.devices} ({group.backend}) started "
            f"in {time.perf_counter() - t0:.3f} s (follower pid "
            f"{group.pids})")
        recs = {}
        for kv, seed in (("fp", 7), ("int8", 8)):
            inp = decode_inputs(dict(K1_SHAPES["small"],
                                     H=cfg.n_head // TP), kv, seed=seed)
            dt = "int8" if kv == "int8" else "bf16"
            recs[kv] = k1_record(inp, f"paged_attention_{dt}_h{inp.H}",
                                 f"{dt} H={inp.H} (a tp={TP} rank's heads)",
                                 card)
            del inp
        shape = (16, cfg.d_model)
        ar_ms = group.all_reduce_ms(shape, 200)

        counted = [0]
        plain_all_reduce = group.all_reduce

        def all_reduce(t):
            counted[0] += 1
            return plain_all_reduce(t)

        group.all_reduce = all_reduce
        # The flight recorder on in this process, rank 0: every
        # engine.dispatch has its shard.dispatch.
        ev._reset_for_tests()
        evdir = tempfile.mkdtemp(prefix="rt-events-tp-")
        rec = ev.init(evdir, proc="chip_smoke_tp")
        try:
            pa.launches = 0
            group.probe(reset=True)
            toks, ttft, tpot, wall, stats = serve(
                params, cfg, reqs, device=dev, attn_kernel="cuda", tp=TP)
            launches = [pa.launches, group.probe()[0]["k1_launches"]]
            n_ar = counted[0]
            counts = ring_counts(rec, ev.read_ring(rec.path))
        finally:
            del group.all_reduce
            ev._reset_for_tests()
            shutil.rmtree(evdir, ignore_errors=True)
        pair = [counts.get("engine.dispatch", 0),
                counts.get("shard.dispatch", 0)]
        log(f"tp2 bf16 recorder on rank 0: engine.dispatch / shard.dispatch "
            f"written + dropped {pair} (dispatches {stats['dispatches']})")
        if pair != [stats["dispatches"]] * 2:
            raise AssertionError(f"tp2: engine/shard dispatch events "
                                 f"{pair}, dispatches "
                                 f"{stats['dispatches']}")
        check_streams("tp2 bf16", toks, reqs, cfg.vocab_size)
        steps = 8 * stats["dispatches"]
        want = cfg.n_layer * steps
        want_ar = 2 * cfg.n_layer * (steps + stats["prefills"])
        log(f"tp2 bf16: K1 launches per rank {launches} (want n_layer*"
            f"chunk*dispatches={want}); all-reduces on rank 0 {n_ar} "
            f"(want 2*n_layer*(steps {steps} + prefills "
            f"{stats['prefills']})={want_ar}: {2 * cfg.n_layer} a decode "
            f"step, and one token broadcast)")
        if stats["completed"] != len(reqs) or launches != [want, want] \
                or want == 0 or n_ar != want_ar:
            raise AssertionError(f"tp2 bf16: completed {stats['completed']}"
                                 f", launches {launches}, all-reduces "
                                 f"{n_ar}")
        compare("tp2 bf16", toks, greedy, "bf16", what="tp=2 vs tp=1",
                model=(params, cfg, reqs), firsts_equal=False)
        recs["fp"]["launches"] = sum(launches)
        n_tok = sum(len(t) for t in toks)
        log(f"tp2 bf16 engine [{card}]: {len(reqs)} requests, {n_tok} "
            f"tokens in {wall:.4f} s = {n_tok / wall:.2f} tok/s; TTFT p50 "
            f"{p50(ttft) * 1e3:.3f} ms; TPOT p50 {p50(tpot) * 1e3:.3f} ms; "
            f"one f32 all-reduce of {list(shape)} {ar_ms:.4f} ms (host, "
            f"gloo); {2 * cfg.n_layer} all-reduces a decode step. Two "
            f"ranks sharing ONE card through gloo's host staging: not a "
            f"speed figure for tensor parallelism across cards")

        pa.launches = 0
        group.probe(reset=True)
        toks8, _, tpot8, _, stats8 = serve(
            params, cfg, reqs32, device=dev, attn_kernel="cuda",
            kv_dtype="int8", tp=TP)
        launches8 = [pa.launches, group.probe()[0]["k1_launches"]]
        check_streams("tp2 int8", toks8, reqs32, cfg.vocab_size)
        want8 = cfg.n_layer * 8 * stats8["dispatches"]
        log(f"tp2 int8: K1 launches per rank {launches8} (want {want8})")
        if stats8["completed"] != len(reqs32) or \
                launches8 != [want8, want8] or want8 == 0:
            raise AssertionError(f"tp2 int8: {stats8}, {launches8}")
        recs["int8"]["launches"] = sum(launches8)
        compare("tp2 int8", toks8, greedy8, "int8", what="tp=2 vs tp=1",
                firsts_equal=False)
        log(f"tp2 int8 engine [{card}]: TPOT p50 {p50(tpot8) * 1e3:.3f} ms")

        params32, cfg32, reqs32_, plain32 = f32_args
        toks32, _, tpot32, _, _ = serve(params32, cfg32, reqs32_,
                                        device=dev, attn_kernel="cuda",
                                        tp=TP)
        check_streams("tp2 f32", toks32, reqs32_, cfg.vocab_size)
        compare("tp2 f32", toks32, plain32, "f32", what="tp=2 vs tp=1",
                firsts_equal=False)
        log(f"tp2 f32 engine [{card}]: TPOT p50 {p50(tpot32) * 1e3:.3f} ms")

        descs, _ = handoffs(params32, cfg32, reqs32_, device=dev,
                            attn_kernel="cuda", tp=TP)
        got, _, _, _, hst = serve(params32, cfg32, reqs32_, device=dev,
                                  attn_kernel="cuda", descs=descs,
                                  role="decode")
        ho = hst["handoff"]
        if ho["imported"] != len(reqs32_) or ho["import_fallbacks"]:
            raise AssertionError(f"tp2 -> tp1 handoff: {ho}")
        check_streams("tp2 -> tp1 handoff", got, reqs32_, cfg.vocab_size)
        same = sum(np_equal(g, r) for g, r in zip(got, plain32))
        log(f"tp2 -> tp1 handoff (f32, paged fp, K1): {same}/{len(got)} "
            f"streams identical to the colocated tp=1 engine's")
        if same != len(got):
            raise AssertionError(f"tp2 -> tp1 handoff: {same}/{len(got)} "
                                 f"streams identical to the colocated "
                                 f"tp=1 engine's")
    finally:
        group.close()
    return [recs["fp"], recs["int8"]]


def np_equal(a, b):
    return a.shape == b.shape and bool((a == b).all())


def p50(xs):
    import numpy as np

    return float(np.percentile(np.asarray(xs), 50))


def serving_requests():
    """The serving phases' 12 requests: prompts of 16-512 tokens, two of
    them sharing a 250-token prefix, 32-64 new tokens each."""
    import numpy as np

    rng = np.random.default_rng(4)
    sysp = rng.integers(0, 50257, (250,)).astype(np.int32)
    lens = [16, 24, 48, 64, 96, 128, 200, 320, 400, 512]
    prompts = [rng.integers(0, 50257, (n,)).astype(np.int32) for n in lens]
    prompts += [np.concatenate([sysp, rng.integers(0, 50257, (n,))]
                               ).astype(np.int32) for n in (40, 60)]
    return [(p, int(m)) for p, m in
            zip(prompts, rng.integers(32, 65, len(prompts)))]


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
    p_card = gpt.init_params(nano, seed=0, device="cuda")
    if not all(torch.equal(p_card[k].cpu().view(torch.int32),
                           v.view(torch.int32)) for k, v in p_cpu.items()):
        raise AssertionError("init_params(nano): the card's draw differs "
                             "from the CPU's")
    log("init_params(nano, seed 0): the card's weights bit-equal to the "
        "CPU's (which equal the reference's, tests/test_torch_init_params.py)")
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, device="cuda",
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"init_params GPT-2 small (the reference's draw for seed 0, bf16 "
        f"storage) on the card [{card}]: {time.perf_counter() - t0:.3f} s "
        f"for {sum(p.numel() for p in params.values())} weights")
    reqs = serving_requests()
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
    compare("small bf16", toks, ref, "bf16", model=(params, cfg, reqs))
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

    # ---- 6b. disaggregated prefill/decode, the engine's lifecycle
    handoff_phase(params, cfg, reqs, toks, (p50(ttft), p50(tpot)), reqs32,
                  toks8, nano_args, card)
    lifecycle_phase(params, cfg, reqs, toks, card)
    batch_infer_phase(params, cfg, card)
    observability_phase(params, cfg, reqs, card)
    batching_phase(params, cfg, reqs, toks, card, greedy_tok_s=n_tok / wall)

    # ---- 6c. tensor-parallel decode: two ranks on this card
    records += tp_phase(params, cfg, reqs, toks, reqs32, toks8,
                        (params32, cfg32, reqs32, plain32["fp"]), card)
    del params, params32
    torch.cuda.empty_cache()

    # ---- 6d. Mixture-of-Experts serving: nano card vs CPU, GPT-2 small
    # with 8 experts through K1
    moe_nano_phase(card)
    moe_serve_phase(reqs, (toks, ttft, tpot, wall), card)

    # ---- 7. training: flash vs xla, nano f32 card vs CPU, GPT-2 small
    flash_vs_xla_phase(card)
    nano_train_phase()
    counts = train_phase(card)
    for rec in flash_records:
        rec["launches"] = counts[rec["name"]]
    records += flash_records

    # ---- 7b. MoE training: flash vs xla at f32, nano card vs CPU, GPT-2
    # small with 8 experts through K2/K3
    flash_vs_xla_phase(card, dataclasses.replace(
        gpt.CONFIGS["small"], n_experts=MOE_EXPERTS, dtype=torch.float32))
    nano_train_phase(n_experts=NANO_MOE_EXPERTS)
    train_phase(card, n_experts=MOE_EXPERTS)

    # ---- 7c. sharded training: two ranks on this card (gloo)
    records += parallel_train_phase(card)

    # ---- 7d. pipeline, expert parallelism (and MoE x tp, MoE x sp),
    # multislice: two ranks (gloo)
    records += pipeline_ep_phase(card)

    # ---- 8. ResNet: ResNet-18 card vs CPU, ResNet-50 serving and a step
    resnet_phase(card)

    # ---- 9. RL: every learner card vs CPU, PPO CartPole, Nature-CNN,
    # two rank learners
    rl_phase(card)

    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
