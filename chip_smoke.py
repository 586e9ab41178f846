#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the build of the paged-attention kernel from the sources in this
   checkout (``nvcc``, timed, with ptxas' register/spill report);
2. the kernel (``ray_tpu_torch/ops/csrc/paged_attention.cu``) held
   against its plain PyTorch version at GPT-2-small shapes (16 slots,
   12 heads, head_dim 64, page 16, 64 table columns, mixed lengths up to
   1023, out-of-order and sentinel-padded tables, a mapped page past
   ``pos``), bf16 fp and int8 pools;
3. kernel timings beside the plain version, ``scaled_dot_product_attention``
   over pre-gathered contiguous K/V (a yardstick timed here only; the
   port never calls it) and the card's bandwidth bound;
4. a small reference check: the nano model at f32 served on the card
   through the kernel gives the same greedy tokens as on the CPU through
   the plain version;
5. the engine at full GPT-2-small width (``CONFIGS["small"]``, bf16,
   seeded random weights): 12 concurrent greedy requests through
   ``DecodeEngine(slots=16, chunk=8, max_len=1024, page_size=16,
   attn_kernel="cuda")`` — every stream completes, the kernel ran
   ``n_layer * chunk`` times per dispatch, and streams match an
   ``attn_kernel="gather"`` engine on the same card within the stated
   divergence budget; then the same requests with 32 new tokens on an
   int8 pool (completion, launch count, budget), and at f32 on fp and
   int8 pools, where kernel and gather engines must agree stream for
   stream;
6. a profiled serve window: device busy time by kernel against wall
   time.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs one card, no network.
"""
import json
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
MAX_DIVERGED = {"bf16": 0.5, "int8": 0.75, "f32": 1}

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


def kernel_phase(kv: str, card: str) -> dict:
    """K1 vs its plain version, then timings, at GPT-2-small shapes. R
    layers' pools are cycled so each timed launch reads pages no earlier
    launch left in the 50 MB L2, as in the decode step."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.models import gpt_decode as gd
    from ray_tpu_torch.ops import paged_attention as pa

    B, H, hd, ps, max_pages, R = 16, 12, 64, 16, 64, 6
    n_pages = B * max_pages + 64
    rng = np.random.default_rng(1 if kv == "fp" else 2)
    pos = np.array([0, 15, 16, 17, 100, 255, 256, 333, 511, 600, 700,
                    800, 900, 1000, 1022, 1023], np.int32)
    pt = np.full((B, max_pages), gd.PT_SENTINEL, np.int32)
    perm = rng.permutation(n_pages)
    used = 0
    for b in range(B):
        n = min(int(pos[b]) // ps + 1 + (b % 3 == 0), max_pages)
        pt[b, :n] = perm[used:used + n]      # out of order; some slots
        used += n                            # map one page past pos
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1 if kv == "fp" else 2)
    q = torch.randn(B, 1, H, hd, device=dev, dtype=torch.bfloat16,
                    generator=gen)
    shape = (R, n_pages, ps, H, hd)
    if kv == "int8":
        kc, vc = (torch.randint(-127, 128, shape, device=dev,
                                dtype=torch.int8, generator=gen)
                  for _ in range(2))
        ks, vs = (torch.rand(R, n_pages, H, device=dev, generator=gen)
                  * 0.02 for _ in range(2))
    else:
        kc, vc = (torch.randn(shape, device=dev, dtype=torch.bfloat16,
                              generator=gen) for _ in range(2))
        ks = vs = None
    ptd = torch.from_numpy(pt).to(dev)
    posd = torch.from_numpy(pos).to(dev)

    def args(i):
        l = i % R
        return (q, kc[l], vc[l], ptd, posd, ps,
                None if ks is None else ks[l], None if vs is None else vs[l])

    err = 0.0
    for l in range(R):
        out = pa.paged_attention_cuda(*args(l))
        ref = pa.paged_attention_gather(*args(l))
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"K1 {kv}: non-finite output")
        err = max(err, (out.float() - ref.float()).abs().max().item())
    log(f"K1 {kv}: kernel vs plain max_abs_err={err:.6g} "
        f"(tolerance {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"K1 {kv}: kernel disagrees with plain "
                             f"version: {err} > {KERNEL_TOL}")

    ms = cuda_ms(lambda i: pa.paged_attention_cuda(*args(i)), 240)
    plain_ms = cuda_ms(lambda i: pa.paged_attention_gather(*args(i)), 30)
    library_ms = None
    if kv == "fp":
        # Pre-gathered contiguous K/V [B, H, V, hd] per layer, masked to
        # <= pos: what a dense attention library call would be handed.
        V = max_pages * ps
        ptc = torch.from_numpy(pt.clip(0, n_pages - 1).astype(np.int64)
                               ).to(dev)
        kd = [kc[l][ptc].reshape(B, V, H, hd).transpose(1, 2).contiguous()
              for l in range(R)]
        vd = [vc[l][ptc].reshape(B, V, H, hd).transpose(1, 2).contiguous()
              for l in range(R)]
        mask = (torch.arange(V, device=dev)[None, :]
                <= posd[:, None].long())[:, None, None, :]
        qd = q.transpose(1, 2).contiguous()          # [B, H, 1, hd]
        library_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
            qd, kd[i % R], vd[i % R], attn_mask=mask), 240)
    positions = int((pos.astype(np.int64) + 1).sum())
    elem = 1 if kv == "int8" else 2
    nbytes = (2 * positions * H * hd * elem          # K and V, live rows
              + 2 * B * H * hd * 2                   # q in, out
              + pt.nbytes + pos.nbytes)
    if kv == "int8":
        live_pages = int(sum(int(p) // ps + 1 for p in pos))
        nbytes += 2 * live_pages * H * 4             # ks, vs
    flops = 4 * positions * H * hd                   # q·k and p·v
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    rec = {"name": f"paged_attention_{'int8' if kv == 'int8' else 'bf16'}",
           "route": "cuda", "source": SOURCE, "replaces": REPLACES,
           "launches": 0, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    log(f"K1 {kv} timing [{card}]: kernel_ms={ms:.6g} plain_ms="
        f"{plain_ms:.6g} library_ms={library_ms} bound_ms="
        f"{rec['bound_ms']:.6g} ({rec['bound_by']}: {nbytes} B, {flops} "
        f"flop) roofline_share={rec['bound_ms'] / ms:.3f}")
    del kc, vc, ks, vs
    torch.cuda.empty_cache()
    return rec


def serve(params, cfg, reqs, *, device, attn_kernel, kv_dtype="fp",
          slots=16, chunk=8, max_len=1024, page_size=16):
    """Queue every request, start the driver, drain all streams from
    their own threads. Returns (streams, ttft_s, tpot_s, wall_s, stats)."""
    import numpy as np
    import torch

    from ray_tpu_torch.serve.engine import DecodeEngine

    eng = DecodeEngine(params, cfg, slots=slots, chunk=chunk,
                       max_len=max_len, page_size=page_size,
                       attn_kernel=attn_kernel, kv_dtype=kv_dtype,
                       device=device, auto_start=False)
    try:
        streams = [eng.stream(p, m) for p, m in reqs]
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
            raise TimeoutError(f"{attn_kernel}/{kv_dtype} engine: streams "
                               f"did not finish within 600 s")
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
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.key, e.count))
    busy_ms = sum(r[0] for r in rows) / 1e3
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


def compare(name, got, ref, precision):
    firsts = all(g[0] == r[0] for g, r in zip(got, ref))
    diverged = [i for i, (g, r) in enumerate(zip(got, ref))
                if not np_equal(g, r)]
    where = {i: int((got[i] != ref[i]).argmax()) for i in diverged}
    budget = MAX_DIVERGED[precision]
    if isinstance(budget, float):
        budget = int(budget * len(got))
    log(f"{name}: kernel vs gather streams: {len(diverged)}/{len(got)} "
        f"diverge (budget {budget}), first divergence at {where}, first "
        f"tokens all equal: {firsts}")
    if not firsts or len(diverged) > budget:
        raise AssertionError(f"{name}: kernel engine outside the "
                             f"divergence budget")


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
    t0 = time.perf_counter()
    lib, compiler_out = pa.build()
    log(f"K1 build: {time.perf_counter() - t0:.3f} s -> {lib}")
    for line in compiler_out.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 2-3. kernel vs plain, timings
    records = [kernel_phase("fp", card), kernel_phase("int8", card)]

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
    for kv in ("fp", "int8"):
        ref32, *_ = serve(params32, cfg32, reqs32, device=dev,
                          attn_kernel="gather", kv_dtype=kv)
        toks32, _, tpot32, wall32, _ = serve(
            params32, cfg32, reqs32, device=dev, attn_kernel="cuda",
            kv_dtype=kv)
        check_streams(f"small f32 {kv}", toks32, reqs32, cfg.vocab_size)
        compare(f"small f32 {kv}", toks32, ref32, "f32")
        log(f"small f32 {kv} engine [{card}]: "
            f"{sum(map(len, toks32)) / wall32:.2f} tok/s; TPOT p50 "
            f"{p50(tpot32) * 1e3:.3f} ms")

    profile_phase(params, cfg, reqs32[:6], card)

    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
