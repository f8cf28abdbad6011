#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, no arguments

Phases (each prints its lines; any failure raises and exits non-zero):

1. device  — the card's name and power limit (nvidia-smi);
2. build   — compile ``qwen3_asr_swift_tpu_torch/csrc/*.cu`` with nvcc,
             one process per source, all started together;
3. k1      — kernel K1 (packed 2/4/8-bit group-quant matmul: exact bf16
             products on the tensor cores, group scales in fp32) against its
             plain version at the decoder's full-width shapes, rows 32 (bf16
             x, as the slice gives it, and fp32 x), 16 (beam's rows), 1, 33
             and 256, 2-, 4- and 8-bit, groups of 32, 64 and 128; it prints
             the profiler's kernels per call (1, or 2 with a K split: no
             cast kernel at bf16 x) and fails on any other count;
4. k2      — kernel K2 (the bit-plane variant with bf16 planes on the
             tensor cores) against its plain version at the same shapes,
             rows 16 (bf16 x, as the pool gives it, and fp32 x), 32, 1, 33
             and 256, 2-, 4- and 8-bit;
5. k3      — kernel K3 (int8-KV decode attention, split over L) against
             its plain version at B=32 (the slice's rows) and B=16 (beam's),
             Hq 16, Hkv 8, D 128, L 580 with holes in ``valid``, called
             as the decoder calls it (bf16 q, bf16 out) and timed so; its
             fp32 output is checked too, and the bf16 output must be that
             rounded. It prints the profiler's kernels per call (1, or 2
             with the merge of the splits: no cast kernel) and fails on any
             other count.
   Each case of k1-k3 also prints its bound (the larger of its bytes over
   3.35 TB/s and its FLOPs over the card's peak for its operand types, and
   which binds) and the device time of one PyTorch call computing the same
   product (K1: fp32 ``torch.mm`` on the dequantized weight, TF32 off; K2:
   bf16 ``torch.mm`` on its bf16 code*scale products, bias left out; K3:
   ``scaled_dot_product_attention`` on the cache dequantized to fp32),
   with operands cold in L2; each sums over one decode step;
6. step    — full-width prefill + first decode step for 2 clips of 8 s,
             fp32 on the card (kernels) and on the host CPU (plain
             versions), logits compared;
7. slice   — ``transcribe_batch`` of 32 × 30 s clips, 100 tokens, packed
             4-bit decoder, int8 KV, dpcm4 wire, 15-token decode chunks;
             the launch counters of K1 and K3 must rise by the decode's count;
8. pool    — the slot pool (``SlotPoolASR``, 16 slots, 8-token ticks) under
             ``quant.KERNEL = "plane"``: 24 clips of 3/8/15/30 s in two
             bursts and a latency probe; every product of the tick goes
             through K2 (its count must rise by ticks × 8 × 113) and K1
             must not run;
9. beam    — ``transcribe_batch`` with ``beam=4`` (K1 and K3 at 16 rows)
             and a sampled decode (temperature, top-k, both penalties) run
             twice with one seed: identical tokens;
10. serve  — the same model behind ``SpeechServer`` answers 4 concurrent
             ``POST /transcribe`` and one ``GET /health`` with the group
             scheduler, and again through the port's slot pool.

Before the slice, phase codec builds the native wire codec with g++ and
encodes the slice's staging buffer with it and with numpy (pcm4 and dpcm4
byte-identical, µ-law within one code on under 1 % of samples); the slice
then fails unless the codec ran (``WIRE_NATIVE_CALLS``) and prints its
host_prep. After serve, the rest of the Qwen3-ASR family:

11. load     — a full-width checkpoint in the published MLX-4bit layout
               (bf16 floats, packed 4-bit decoder, byte-level vocab), written
               to a temporary directory and loaded with
               ``Qwen3ASR.from_pretrained``: greedy tokens equal to the model
               built in memory from the same arrays;
12. groupdot — ``quant_compute="groupdot"``: the decode-step logits card vs
               host (as in step), 8 × 8 s clips at 32 tokens, K1 once a step
               (the packed LM head) and K3 every layer;
13. vad      — Silero VAD (random, seed 0) over a 60 s stream: card vs host
               within 1e-4, chunk-by-chunk streaming within 1e-5 of the batch;
14. stream   — ``StreamingASR`` over the slice's model and that VAD, 20 s in
               100 ms pushes: partials and finals, each final the stream's
               span and equal to a direct ``transcribe`` of it; K1, K3 run;
15. align    — ``Qwen3ForcedAligner`` at the published widths (5000 classes):
               slot logits card vs host within 5e-2 relative L2, monotone
               times, K1 only when the prompt has at most 256 rows.

Weights are random (numpy, seed 0) at the full width of the 0.6B
configuration. The line before the last is ``{"kernels": [...]}`` (each
entry with its launches in the main path's run, its bound and its library
time); the last line is ``{"ok": true, "device": {...}}``. Imports nothing
of JAX nor of the JAX package, and checks so before the last lines.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

K1_TOL = 1e-4   # max|err| / max|ref|: fp32 sum order + fused multiply-adds
# max|err| / max|ref|: K2 rounds exactly as its plain version does (bf16 x,
# scales and code*scale products); only its fp32 tensor-core sums differ
# from the plain version's float64 ones
K2_TOL = 1e-4
K3_TOL = 1e-4   # max|err| / max|ref|: fp32 sum order over 580 keys, split softmax
# K3's bf16 output (the decoder's) is its fp32 result rounded once: two fp32
# values within K3_TOL of each other round at most one bf16 ulp apart, and
# an ulp is at most 2^-7 of the largest |ref|
K3_BF16_TOL = 2.0 ** -7
# relative L2 of the first decode step's logits, card vs host CPU. The
# decoder runs in bf16 even in an fp32 model, because the packed embedding
# lookup returns bf16 rows (as the reference's does); fp32 sums taken in
# another order flip single bf16 roundings, which compound over 28 layers.
STEP_TOL = 5e-2
# the published peaks of one H100 SXM (dense), for the bounds: a product's
# operations are priced at the card's peak for its operand types, whatever
# pipe the kernel runs on today
HBM_BYTES_S = 3.35e12
PEAK_BF16_TC = 989e12       # bf16 tensor cores
# peak per x dtype of K1, whose codes are exact in bf16: bf16 x enters the
# bf16 tensor cores as it is; fp32 x exactly only as three bf16 terms, three
# passes
K1_PEAK = {"bfloat16": PEAK_BF16_TC, "float32": PEAK_BF16_TC / 3}
K2_PEAK = {"bfloat16": PEAK_BF16_TC, "float32": PEAK_BF16_TC}  # K2 rounds x to bf16
SLICE_CLIPS, SLICE_CLIP_S, SLICE_TOKENS = 32, 30, 100
POOL_SLOTS, POOL_TICK, POOL_MAX_NEW = 16, 8, 64
POOL_SECONDS, POOL_BURSTS = (3, 8, 15, 30), (16, 8)
DECODE_PRODUCTS = 28 * 4 + 1     # packed products of one decode step
SR = 16000
VAD_PROB_TOL = 1e-4      # card vs host CPU, fp32 both (the VAD's convs are fp32 matmuls)
VAD_STREAM_TOL = 1e-5    # process_chunk (batch 1) vs the batch pass, on the card
ALIGN_TOL = 5e-2         # classify logits at the slots, relative L2, card vs host CPU
ALIGN_TEXT = ("the quick brown fox jumps over the lazy dog while seven small birds sing "
              "songs about rain and wind in the old garden")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def input_sets(make, bytes_per_set: int, cold_bytes: int = 192 << 20):
    """Enough copies of one call's inputs that cycling through them
    overflows the card's 50 MB L2: on the main path every layer reads its
    own weights and cache, so a kernel meets its operands cold."""
    return [make() for _ in range(max(2, -(-cold_bytes // bytes_per_set)))]


def time_turns(calls, iters: int = 24, warmup: int = 3):
    """Per-call times of several functions, each cycling through its own
    ``sets`` of arguments, in turns: a, b, ..., ..., b, a. ``calls`` is a
    list of (fn, sets). Returns one (wall_ms, device_ms, device_source,
    kernels_per_call, by_kernel) tuple per call: wall from CUDA events
    around the loop, launch gaps included; device time from the profiler
    (every kernel the call launched), or from CUDA events around each call
    where the profiler kept dropping events (``device_source`` says which);
    the most kernels per call that a profiler window showed; and the device
    ms per call of each kernel, by its function name, from the windows the
    device time was taken from (empty where that was CUDA events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def loop(fn, sets, n):
        for i in range(n):
            fn(*sets[i % len(sets)])

    def wall(fn, sets):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        loop(fn, sets, iters)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / iters

    def kernels_in(fn, sets, n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop(fn, sets, n)
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    def by_name(kernels):
        """device ms per call of each kernel, by its function name alone"""
        out = {}
        for e in kernels:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].split()[-1]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
        return out

    def device(fn, sets):
        # the profiler now and then drops a window's device events. A timed
        # window counts only if its kernels per call are the most that any
        # window showed (two windows of ``warmup`` calls, then each timed
        # one) and at least one other window showed as many; after five
        # that do not, the time is CUDA events around each call (launch
        # gaps included), and the source says so
        per_call = [len(kernels_in(fn, sets, warmup)) / warmup for _ in range(2)]
        for _ in range(5):
            kernels = kernels_in(fn, sets, iters)
            per_call.append(len(kernels) / iters)
            top = max(per_call)
            if top and per_call[-1] == top and per_call.count(top) >= 2:
                return (sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters, "profiler",
                        top, by_name(kernels))
        log(f"  (the profiler's kernels per call in seven windows: {per_call}: device time "
            f"from CUDA events around each call)")
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)]
        for i, (ev0, ev1) in enumerate(evs):
            ev0.record()
            fn(*sets[i % len(sets)])
            ev1.record()
        torch.cuda.synchronize()
        return (sum(ev0.elapsed_time(ev1) for ev0, ev1 in evs) / iters, "cuda_events",
                max(per_call), {})

    for i in range(warmup):
        for fn, sets in calls:
            fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    order = list(range(len(calls))) + list(reversed(range(len(calls))))
    out = [[0.0, 0.0, "profiler", 0.0, {}] for _ in calls]
    for j in order:
        out[j][0] += wall(*calls[j]) / 2
    for j in order:
        ms, source, per_call, kernels = device(*calls[j])
        out[j][1] += ms / 2
        out[j][3] = max(out[j][3], per_call)
        if source != "profiler":
            out[j][2] = source
        for name, k_ms in kernels.items():
            out[j][4][name] = out[j][4].get(name, 0.0) + k_ms / 2
    for t in out:
        if t[2] != "profiler":
            t[4] = {}   # one window's kernels are not the whole call's
    return [tuple(t) for t in out]


def bound(n_bytes: float, flops: float, peak_flops: float):
    """(ms, what binds): the least time the card could take, the larger of
    the bytes over the memory rate and the operations over the peak of the
    pipe the kernel uses."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_source(from_events) -> str:
    """Where a kernel's device times came from, for its ``kernels`` entry."""
    return "profiler" + (f"; CUDA events for {', '.join(from_events)}" if from_events else "")


def rel_err(got, ref) -> tuple:
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


# --------------------------------------------------------------------------- #

HIDDEN, INTER, VOCAB, NQ, NKV = 1024, 3072, 151936, 16 * 128, 2 * 8 * 128


def step_cases(rows: int, per_step: int, xdt="float32"):
    """(name, rows, in, out, bits, calls per decode step, x dtype, group
    size) of one decode step."""
    return [("qkv", rows, HIDDEN, NQ + NKV, 4, 28 * per_step, xdt, 64),
            ("o", rows, NQ, HIDDEN, 4, 28 * per_step, xdt, 64),
            ("gate_up", rows, HIDDEN, 2 * INTER, 4, 28 * per_step, xdt, 64),
            ("down", rows, INTER, HIDDEN, 4, 28 * per_step, xdt, 64),
            ("lm_head", rows, HIDDEN, VOCAB, 4, per_step, xdt, 64)]


def packed_pair(dev, label, kernel, plain, library, cases, tol, seed, peak):
    """A packed-matmul kernel against its plain version at each case's
    shape, timed beside its library yardstick. ``library(x, p)`` returns
    (fn, args) with the yardstick's operands materialised (not timed);
    ``peak`` maps the x dtype to the FLOP/s of the bound. Returns (worst
    max-abs error, sums over one decode step's calls of: kernel and plain
    CUDA-event ms, kernel and plain device ms, bound ms, library device ms;
    the bound's binding term of the largest call; the cases whose device
    times are CUDA events, not the profiler's; and per case, the kernel's
    most kernels per call in a profiler window, with its device source)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    step = dict(ms=0.0, plain_ms=0.0, device_ms=0.0, plain_device_ms=0.0, bound_ms=0.0,
                library_ms=0.0)
    bound_by, top = None, 0.0
    from_events = []   # cases whose device times are CUDA events, not the profiler
    launches = []      # per case: (kernels per call, device source)
    for name, rows, d_in, d_out, bits, per_step, xdt, gs in cases:
        def make():
            p = {"codes": torch.randint(-2**31, 2**31 - 1, (d_out, d_in * bits // 32),
                                        generator=g, device=dev, dtype=torch.int32),
                 "scales": torch.rand((d_out, d_in // gs), generator=g, device=dev) * 0.02,
                 "biases": (torch.rand((d_out, d_in // gs), generator=g, device=dev) - 0.5) * 0.2}
            x = torch.randn((rows, d_in), generator=g, device=dev).to(getattr(torch, xdt))
            return x, p

        w_bytes = d_out * (d_in * bits // 8 + 2 * 4 * d_in // gs)
        sets = input_sets(make, w_bytes)
        got = kernel(*sets[0])
        ref = plain(*sets[0])
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        del got, ref
        lib_fn, lib0 = library(*sets[0])
        lib_sets = input_sets(lambda: library(*make())[1], sum(
            t.numel() * t.element_size() for t in lib0))
        timed = time_turns([(kernel, sets), (plain, sets), (lib_fn, lib_sets)])
        (ms, dev_ms, source, per_call, _), (plain_ms, plain_dev_ms, *_), (_, lib_dev_ms, *_) = timed
        launches.append((per_call, source))
        from_events += [f"{name} x={xdt} {what}"
                        for what, t in zip(("kernel", "plain", "library"), timed)
                        if t[2] != "profiler"]
        x_bytes = rows * d_in * sets[0][0].element_size()
        b_ms, b_by = bound(w_bytes + x_bytes + rows * d_out * 4, 2 * rows * d_out * d_in,
                           peak[xdt])
        log(f"{label} {name:12s} rows={rows:3d} in={d_in:4d} out={d_out:6d} bits={bits} gs={gs} "
            f"x={xdt} max_abs_err={err:.3e} rel={rel:.3e} (tol {tol:g}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} device: kernel_ms={dev_ms:.4f} plain_ms={plain_dev_ms:.4f} "
            f"library_ms={lib_dev_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"bound/kernel={b_ms / dev_ms:.3f} kernel/library={dev_ms / lib_dev_ms:.2f} "
            f"kernels/call={per_call:g} ({source})")
        if not rel <= tol:
            raise AssertionError(f"{label} {name}: rel error {rel} > {tol}")
        worst = max(worst, err)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("device_ms", dev_ms),
                     ("plain_device_ms", plain_dev_ms), ("bound_ms", b_ms),
                     ("library_ms", lib_dev_ms)):
            step[k] += per_step * v
        if per_step and per_step * b_ms > top:
            top, bound_by = per_step * b_ms, b_by
        del sets, lib_sets, lib0
    return worst, step, bound_by, from_events, launches


def log_step(label, what, step):
    log(f"{label} per decode step ({what}): kernel_ms={step['ms']:.4f} "
        f"plain_ms={step['plain_ms']:.4f} device: kernel_ms={step['device_ms']:.4f} "
        f"plain_ms={step['plain_device_ms']:.4f} library_ms={step['library_ms']:.4f} "
        f"bound_ms={step['bound_ms']:.4f} bound/kernel={step['bound_ms'] / step['device_ms']:.3f}")


def k1_library(x, p):
    """K1's yardstick: one fp32 GEMM on the dequantized weight (the bias
    term folded into W), TF32 off: K1's fp32 function in one library call."""
    import torch

    from qwen3_asr_swift_tpu_torch.ops import quant

    return torch.mm, (x.float(), quant.dequantize(p, x.shape[-1]).t())


def k2_library(x, p):
    """K2's time yardstick: one bf16 GEMM on the bf16 ``code·scale``
    products K2 forms (its bias term left out)."""
    import torch

    from qwen3_asr_swift_tpu_torch.ops import quant

    d_in = x.shape[-1]
    bits, gs = quant.infer_quant_dims(d_in, p["codes"].shape, p["scales"].shape)
    s_exp = torch.repeat_interleave(p["scales"], gs, dim=-1).to(torch.bfloat16)
    w = quant.unpack_codes(p["codes"], bits, d_in).to(torch.bfloat16) * s_exp
    return torch.mm, (x.to(torch.bfloat16), w.t())


def phase_k1(dev):
    import torch

    from qwen3_asr_swift_tpu_torch.ops import cuda_build, quant

    torch.backends.cuda.matmul.allow_tf32 = False
    # the main path hands K1 bf16 activations (a packed embedding returns
    # bf16 rows); rows 32 carry the per-step sum; rows 16 are beam search's
    qkv = (HIDDEN, NQ + NKV)
    cases = step_cases(32, 1, "bfloat16") + step_cases(16, 0, "bfloat16") + [
        ("qkv_rows1", 1, *qkv, 4, 0, "bfloat16", 64),
        ("qkv_rows33", 33, *qkv, 4, 0, "bfloat16", 64),
        ("qkv_rows256", 256, *qkv, 4, 0, "bfloat16", 64),
        ("qkv_bits2", 32, *qkv, 2, 0, "bfloat16", 64),
        ("qkv_bits8", 32, *qkv, 8, 0, "bfloat16", 64),
        ("qkv_gs32", 32, *qkv, 4, 0, "bfloat16", 32),
        ("qkv_gs128", 32, *qkv, 4, 0, "bfloat16", 128),
        ("down_bits2_gs32", 32, INTER, HIDDEN, 2, 0, "bfloat16", 32)]
    worst, step, bound_by, from_events, per_call = packed_pair(
        dev, "K1", quant.quant_matmul_cuda, quant.quant_matmul, k1_library, cases, K1_TOL,
        seed=0, peak=K1_PEAK)
    log_step("K1", "28 layers x 4 + LM head, rows 32, bf16 x", step)
    # kernels per call at bf16 x: the kernel, and the split sum where K is
    # split; a cast of x would show as one more
    lib = cuda_build.library()
    for (name, rows, d_in, d_out, bits, _, _, gs), (n, source) in zip(cases, per_call):
        want = 1 + (lib.qs_quant_matmul_workspace(rows, d_in, d_out, bits, gs, 1) > 0)
        if source == "profiler" and n != want:
            raise AssertionError(f"K1 {name}: {n:g} kernels per call at bf16 x, not {want}")
    log("K1 kernels per call at bf16 x (profiler): " + ", ".join(
        f"{c[0]} {n:g}" for c, (n, _) in zip(cases, per_call)))
    worst32, step32, _, from_events32, _ = packed_pair(
        dev, "K1", quant.quant_matmul_cuda, quant.quant_matmul, k1_library,
        step_cases(32, 1, "float32"), K1_TOL, seed=3, peak=K1_PEAK)
    log_step("K1", "28 layers x 4 + LM head, rows 32, fp32 x", step32)
    return dict({"name": "quant_matmul_cuda", "route": "cuda",
                 "source": "qwen3_asr_swift_tpu_torch/csrc/quant_matmul.cu",
                 "replaces": "qwen3_asr_swift_tpu/ops/quant.py:252",
                 "max_abs_err": max(worst, worst32)}, **step, bound_by=bound_by,
                device_source=device_source(from_events + from_events32),
                fp32_x_device_ms=step32["device_ms"],
                design="bf16 mma.sync on exact codes and x (fp32 x as three bf16 terms), "
                       "each group's sum scaled in fp32; cp.async-staged codes, scales and x "
                       "tile; K split at out 1024",
                library_call="torch.mm(x_f32, dequantize(p).t()), allow_tf32=False",
                ms_per="one decode step at batch 32, bf16 x (28x qkv, o, gate_up, down + LM "
                       "head), operands cold in L2")


def phase_k2(dev):
    from qwen3_asr_swift_tpu_torch.ops import quant

    # the pool hands K2 bf16 activations; rows 16 (its slots) carry the
    # per-step sum; rows 32, 1, 33, 256 and the 2- and 8-bit packings are
    # checked and timed beside them, then one step again with fp32 x
    cases = step_cases(16, 1, "bfloat16") + step_cases(32, 0, "bfloat16") + [
        ("qkv_rows1", 1, HIDDEN, NQ + NKV, 4, 0, "bfloat16", 64),
        ("qkv_rows33", 33, HIDDEN, NQ + NKV, 4, 0, "bfloat16", 64),
        ("qkv_rows256", 256, HIDDEN, NQ + NKV, 4, 0, "bfloat16", 64),
        ("qkv_bits2", 32, HIDDEN, NQ + NKV, 2, 0, "bfloat16", 64),
        ("qkv_bits8", 32, HIDDEN, NQ + NKV, 8, 0, "bfloat16", 64)]
    worst, step, bound_by, from_events, _ = packed_pair(
        dev, "K2", quant.quant_matmul_plane_cuda, quant.quant_matmul_plane, k2_library, cases,
        K2_TOL, seed=4, peak=K2_PEAK)
    log_step("K2", "28 layers x 4 + LM head, rows 16, bf16 x", step)
    worst32, step32, _, from_events32, _ = packed_pair(
        dev, "K2", quant.quant_matmul_plane_cuda, quant.quant_matmul_plane, k2_library,
        step_cases(16, 1, "float32"), K2_TOL, seed=5, peak=K2_PEAK)
    log_step("K2", "28 layers x 4 + LM head, rows 16, fp32 x", step32)
    return dict({"name": "quant_matmul_plane_cuda", "route": "cuda",
                 "source": "qwen3_asr_swift_tpu_torch/csrc/quant_matmul_plane.cu",
                 "replaces": "qwen3_asr_swift_tpu/ops/quant.py:208",
                 "max_abs_err": max(worst, worst32)}, **step, bound_by=bound_by,
                device_source=device_source(from_events + from_events32),
                fp32_x_device_ms=step32["device_ms"],
                library_call="torch.mm(x_bf16, W_bf16.t()) on the bf16 code*scale products, "
                             "bias term left out: a time yardstick only",
                ms_per="one decode step at 16 rows, bf16 x (28x qkv, o, gate_up, down + LM "
                       "head), operands cold in L2")


def k3_inputs(dev, b, seed):
    """Operand sets of K3 at ``b`` rows of the slice's shape (Hq 16, Hkv 8,
    D 128, L 580, bf16 q, holes in ``valid``, the unwritten decode rows
    masked), enough of them to meet their operands cold in L2."""
    import torch

    from qwen3_asr_swift_tpu_torch.ops.kv_cache import quantize_kv

    g = torch.Generator(device=dev).manual_seed(seed)
    hq, hkv, length, d = 16, 8, 580, 128

    def make():
        q = torch.randn((b, hq, 1, d), generator=g, device=dev).to(torch.bfloat16)
        kq, ks = quantize_kv(torch.randn((b, hkv, length, d), generator=g, device=dev))
        vq, vs = quantize_kv(torch.randn((b, hkv, length, d), generator=g, device=dev))
        valid = torch.rand((b, length), generator=g, device=dev) > 0.3
        valid[:, 448:] = False   # the unwritten decode rows
        valid[:, 40] = True
        return q, kq, ks, vq, vs, valid

    return input_sets(make, 2 * b * hkv * length * (d + 4))


def k3_case(dev, b, seed, call=None, yardsticks=True):
    """K3 at ``b`` rows on ``k3_inputs``, called as the decoder calls it:
    ``call``, by default the wrapper with ``out_dtype=torch.bfloat16``. Its
    fp32 output is held against the plain version, and its bf16 output
    against the plain version's rounded to bf16 and, bit for bit, against
    its own fp32 output rounded. Timed (operands cold in L2) beside the
    plain version with the same rounding and one
    ``scaled_dot_product_attention`` call, or alone without ``yardsticks``.
    Returns the case's numbers per call."""
    import torch
    import torch.nn.functional as F

    from qwen3_asr_swift_tpu_torch.ops import attention_int8

    k3, bf16 = attention_int8.decode_attention_int8, torch.bfloat16
    if call is None:
        def call(*args):
            return k3(*args, out_dtype=bf16)

    def plain(*args):
        return attention_int8.decode_attention_int8_ref(*args).to(bf16)

    sets = k3_inputs(dev, b, seed)
    _, hq, _, d = sets[0][0].shape
    hkv, length = sets[0][1].shape[1:3]

    try:   # grouped heads in the library call where this PyTorch has them
        F.scaled_dot_product_attention(torch.zeros(1, 2, 1, 8, device=dev),
                                       torch.zeros(1, 1, 4, 8, device=dev),
                                       torch.zeros(1, 1, 4, 8, device=dev), enable_gqa=True)
        gqa = True
    except TypeError:
        gqa = False

    def sdpa(q, k, v, mask):
        if gqa:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def library_args(q, kq, ks, vq, vs, valid):
        """fp32 q and the cache dequantized to fp32, the boolean mask."""
        k, v = kq.float() * ks[..., None], vq.float() * vs[..., None]
        if not gqa:
            k, v = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
        return q.float(), k, v, valid[:, None, None, :]

    got32, got = k3(*sets[0]), call(*sets[0])
    ref = attention_int8.decode_attention_int8_ref(*sets[0])
    torch.cuda.synchronize()
    err, rel = rel_err(got32, ref)
    err16, rel16 = rel_err(got, ref.to(bf16))
    rounded = got.dtype == bf16 and torch.equal(got, got32.to(bf16))
    calls = [(call, sets)]
    lib_rel = float("nan")
    if yardsticks:
        _, lib_rel = rel_err(sdpa(*library_args(*sets[0])), ref)
        calls += [(plain, sets), (sdpa, [library_args(*st) for st in sets])]
    timed = time_turns(calls)
    ms, dev_ms, _, per_call, by_kernel = timed[0]
    plain_ms = plain_dev_ms = lib_dev_ms = float("nan")
    if yardsticks:
        (plain_ms, plain_dev_ms, *_), (_, lib_dev_ms, *_) = timed[1:]
    from_events = [f"B={b} {what}" for what, t in zip(("kernel", "plain", "library"), timed)
                   if t[2] != "profiler"]
    q_bytes = b * hq * d * sets[0][0].element_size()
    out_bytes = b * hq * d * got.element_size()
    n_bytes = 2 * b * hkv * length * (d + 4) + q_bytes + b * length + out_bytes
    # bf16 q against an int8 cache, exact in bf16: priced at the bf16 tensor cores
    b_ms, b_by = bound(n_bytes, 4 * b * hq * length * d, PEAK_BF16_TC)
    log(f"K3 B={b} Hq={hq} Hkv={hkv} L={length} D={d} fp32 out: max_abs_err={err:.3e} "
        f"rel={rel:.3e} (tol {K3_TOL:g}); bf16 out: max_abs_err={err16:.3e} rel={rel16:.3e} "
        f"(tol {K3_BF16_TOL:g}), = fp32 out rounded: {rounded}; timed with bf16 out: "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"device: kernel_ms={dev_ms:.4f} plain_ms={plain_dev_ms:.4f} library_ms={lib_dev_ms:.4f} "
        f"(sdpa fp32, enable_gqa={gqa}, rel {lib_rel:.1e}) bound_ms={b_ms:.4f} ({b_by}) "
        f"bound/kernel={b_ms / dev_ms:.3f} kernel/library={dev_ms / lib_dev_ms:.2f} "
        f"kernels/call={per_call:g} ({'profiler' if not from_events else 'CUDA events'}); "
        f"by kernel: " + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()))
    if not rel <= K3_TOL:
        raise AssertionError(f"K3 B={b}: rel error {rel} > {K3_TOL} (fp32 out)")
    if not rel16 <= K3_BF16_TOL:
        raise AssertionError(f"K3 B={b}: rel error {rel16} > {K3_BF16_TOL} (bf16 out)")
    if not rounded:
        raise AssertionError(f"K3 B={b}: the bf16 output is not the fp32 output rounded")
    return {"b": b, "length": length, "d": d, "max_abs_err": max(err, err16), "ms": ms,
            "plain_ms": plain_ms, "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_dev_ms,
            "kernels_per_call": per_call, "from_events": from_events, "by_kernel": by_kernel,
            "library_call": "scaled_dot_product_attention on fp32 q and the cache "
                            f"dequantized to fp32, boolean mask, enable_gqa={gqa}"}


def phase_k3(dev):
    from qwen3_asr_swift_tpu_torch.ops import attention_int8

    # B 32 is the slice's rows, B 16 beam's (4 clips x beam 4)
    b32, b16 = k3_case(dev, 32, seed=1), k3_case(dev, 16, seed=2)
    # kernels per call: the split kernel, and the merge where L takes more
    # than one split; a cast of q or of the output would show as one more
    split = attention_int8.split_keys(b32["length"], b32["d"])
    want = 1 + (split < b32["length"])
    for case in (b32, b16):
        if not case["from_events"] and case["kernels_per_call"] != want:
            raise AssertionError(f"K3 B={case['b']}: {case['kernels_per_call']:g} kernels per "
                                 f"call, not {want}")
    log(f"K3 kernels per call (profiler): B=32 {b32['kernels_per_call']:g}, "
        f"B=16 {b16['kernels_per_call']:g}; split {split} keys, "
        f"{-(-b32['length'] // split)} splits")
    return {"name": "decode_attention_int8", "route": "cuda",
            "source": "qwen3_asr_swift_tpu_torch/csrc/decode_attn_int8.cu",
            "replaces": "qwen3_asr_swift_tpu/ops/attention_pallas.py:33",
            "max_abs_err": max(b32["max_abs_err"], b16["max_abs_err"]),
            "ms": 28 * b32["ms"], "plain_ms": 28 * b32["plain_ms"],
            "device_ms": 28 * b32["device_ms"], "plain_device_ms": 28 * b32["plain_device_ms"],
            "bound_ms": 28 * b32["bound_ms"], "bound_by": b32["bound_by"],
            "library_ms": 28 * b32["library_ms"],
            "device_source": device_source(b32["from_events"] + b16["from_events"]),
            "b16_device_ms": 28 * b16["device_ms"], "b16_bound_ms": 28 * b16["bound_ms"],
            "b16_library_ms": 28 * b16["library_ms"],
            "design": f"split-L ({split} keys a block at L {b32['length']}), K/V tiles "
                      "cp.async-staged through a two-tile ring, splits merged in order by "
                      "a second kernel; bf16 q in, bf16 out",
            "library_call": b32["library_call"],
            "ms_per": "one decode step at batch 32 (28 layers), bf16 q and bf16 out as the "
                      "decoder calls it, operands cold in L2; b16_*: at batch 16 (beam's rows)"}


def make_weights():
    from qwen3_asr_swift_tpu_torch.core.params import init_random_params
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import CONFIG_SMALL

    t0 = time.perf_counter()
    enc, dec = init_random_params(CONFIG_SMALL, seed=0, quant_bits=4)
    log(f"weights: CONFIG_SMALL random seed 0, decoder packed 4-bit group 64 "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    return enc, dec


def model_options(**kw):
    """The slice's model options (packed 4-bit decoder, int8 KV, dpcm4
    wire, chunks of 15), ``kw`` over them."""
    import torch

    opts = dict(kv_dtype=torch.int8, wire_dtype="dpcm4", decode_chunk_tokens=15,
                quant_compute="packed", audio_buckets_s=(8, 16, 32, 64))
    opts.update(kw)
    return opts


def build_model(enc, dec, device, dtype, **kw):
    import dataclasses

    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import CONFIG_SMALL, Qwen3ASR

    cfg = dataclasses.replace(CONFIG_SMALL, decoder=dataclasses.replace(
        CONFIG_SMALL.decoder, bits=4, group_size=64))
    return Qwen3ASR.from_params(cfg, enc, dec, device=device, dtype=dtype, **model_options(**kw))


def phase_step(weights, label="step", **kw):
    """Full-width prefill + first decode step, card (kernels) vs host CPU
    (plain versions), both fp32 with TF32 off; ``kw`` go to the model."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.qwen3_asr.decoder import decode_step
    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    clips = [(0.1 * rng.standard_normal(8 * 16000)).astype(np.float32) for _ in range(2)]
    out = {}
    tok = None
    for where in ("cpu", "cuda"):
        model = build_model(*weights, where, torch.float32, **kw)
        t0 = time.perf_counter()
        with torch.inference_mode():
            st = model.prestage(clips)
            audio_tokens, n_audio = model._encode(st)
            prompt = model._prompt(st.b, None, None)
            state = model._gen_start(audio_tokens, n_audio, prompt, 4, SamplingOptions(max_tokens=4))
            if tok is None:
                tok = state.tokens[:, 0].cpu()
            logits, _ = decode_step(model.decoder_params, model.cfg.decoder, tok.to(model.device),
                                    state.cache)
        out[where] = (audio_tokens.float().cpu(), logits.float().cpu())
        log(f"{label} on {where}: {time.perf_counter() - t0:.1f} s")
        del model
    torch.backends.cudnn.allow_tf32 = True
    enc_rel = (torch.linalg.vector_norm(out["cuda"][0] - out["cpu"][0])
               / torch.linalg.vector_norm(out["cpu"][0])).item()
    rel = (torch.linalg.vector_norm(out["cuda"][1] - out["cpu"][1])
           / torch.linalg.vector_norm(out["cpu"][1])).item()
    same = (out["cuda"][1].argmax(-1) == out["cpu"][1].argmax(-1)).tolist()
    log(f"{label}: encoder rel L2 {enc_rel:.3e}; decode-step logits rel L2 {rel:.3e} "
        f"(tol {STEP_TOL:g}); argmax equal per clip {same}")
    if not rel <= STEP_TOL:
        raise AssertionError(f"decode-step logits rel L2 {rel} > {STEP_TOL}")


def device_times(run):
    """Run ``run()`` once under the profiler: ({kernel name: device µs
    summed over its instances}, wall s)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return by_name, wall


def phase_slice(model, counters, dev_name, power):
    import torch

    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

    rng = np.random.default_rng(0)
    sr = 16000
    clips = [(0.1 * rng.standard_normal(SLICE_CLIP_S * sr)).astype(np.float32)
             for _ in range(SLICE_CLIPS)]
    opts = SamplingOptions(max_tokens=SLICE_TOKENS)
    t0 = time.perf_counter()
    model.transcribe_batch(clips[:2], options=SamplingOptions(max_tokens=2))  # allocator warm-up
    torch.cuda.synchronize()
    log(f"slice warm-up: {time.perf_counter() - t0:.1f} s")
    # n_gen = sum(tokens != pad_id) per row, as the model computes it, read
    # where it hands it to _finalize
    n_gens = []
    finalize = model._finalize

    def capture(tokens, n_gen, *rest):
        n_gens.append(n_gen.copy())
        return finalize(tokens, n_gen, *rest)

    model._finalize = capture
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = model.transcribe_batch(clips, options=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.name: c.value for c in counters}
    del model._finalize
    steps = SLICE_TOKENS - 1
    need_k1, need_k3 = steps * 28 * 4 + steps, steps * 28
    log(f"slice: {SLICE_CLIPS} x {SLICE_CLIP_S} s, {SLICE_TOKENS} tokens: wall {wall:.3f} s, "
        f"{SLICE_CLIPS * SLICE_CLIP_S / wall:.1f} audio-s/s on {dev_name} ({power}); launches {launches}")
    if len(results) != SLICE_CLIPS:
        raise AssertionError(f"{len(results)} results for {SLICE_CLIPS} clips")
    (n_gen,) = n_gens
    log(f"slice: n_gen per row min {n_gen.min()} max {n_gen.max()}")
    for i, r in enumerate(results):
        if n_gen[i] == 0 or not np.isfinite(r.confidence):
            raise AssertionError(f"clip {i}: n_gen {n_gen[i]}, confidence {r.confidence}")
    if launches["quant_matmul_cuda"] < need_k1 or launches["decode_attention_int8"] < need_k3:
        raise AssertionError(f"launch counters {launches} below K1 {need_k1} / K3 {need_k3}")
    if launches["wire_codec"] < 1:
        raise AssertionError(f"the native wire codec did not run: {launches}")

    # where the time goes (information): stage times with a sync at each
    # boundary, then the device's busy share under the profiler
    timings = {}
    model.transcribe_batch(clips, options=opts, timings=timings)
    log("slice stages (synced at boundaries): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
        + f"; host_prep with the native wire codec {timings['host_prep']:.3f} s on {dev_name} "
          f"({power}); with the numpy encoder it was 0.579 s on NVIDIA H100 80GB HBM3, "
          f"700.00 W")
    by_name, prof_wall = device_times(lambda: model.transcribe_batch(clips, options=opts))
    busy = sum(by_name.values()) / 1e6
    log(f"slice under the profiler: wall {prof_wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / prof_wall:.1f} %), idle {100 * (1 - busy / prof_wall):.1f} %")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")
    # per hand-written kernel, all its instances (K1's split sum with K1:
    # K2, which shares it, does not run here)
    for label, marks in (("K1", ("::quant_matmul_kernel<", "::split_sum(")),
                         ("K3", ("::decode_attn_int8_split<", "::decode_attn_int8_merge("))):
        us = sum(v for k, v in by_name.items() if any(m in k for m in marks))
        log(f"slice under the profiler: {label} device {us / 1e3:.2f} ms")
    return launches, wall


def phase_pool(model, counters, dev_name, power):
    """The slot pool under K2: two bursts of mixed-length clips and a
    latency probe; every request's token list is read where ``_retire``
    reads it."""
    import torch

    from qwen3_asr_swift_tpu_torch.ops import quant
    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions
    from qwen3_asr_swift_tpu_torch.serving import SlotPoolASR

    k1, k2 = counters
    rng = np.random.default_rng(5)
    sr = 16000
    n_bulk = sum(POOL_BURSTS)
    seconds = [POOL_SECONDS[i % len(POOL_SECONDS)] for i in range(n_bulk)]
    clips = [(0.1 * rng.standard_normal(s * sr)).astype(np.float32) for s in seconds]
    probe = (0.1 * rng.standard_normal(2 * sr)).astype(np.float32)
    eos = model.cfg.eos_id
    saved = quant.KERNEL
    quant.KERNEL = "plane"
    try:
        pool = SlotPoolASR(model, slots=POOL_SLOTS, tick_tokens=POOL_TICK, max_new=POOL_MAX_NEW,
                           max_len=SlotPoolASR.max_len_for(model, 32, POOL_MAX_NEW))
        try:
            warm = pool.submit(probe, max_new=2)          # allocator and kernel warm-up
            warm.result(timeout=300)
            torch.cuda.synchronize()
            retired = {}
            retire = pool._retire

            def capture(slot):
                live = pool._live[slot]
                retired[id(live.fut)] = list(live.tokens)
                return retire(slot)

            pool._retire = capture
            ticks0 = pool._ticks
            for c in (k1, k2):
                c.reset()
            t0 = time.perf_counter()
            futs = [pool.submit(c) for c in clips[:POOL_BURSTS[0]]]
            futs[0].result(timeout=600)
            futs += [pool.submit(c) for c in clips[POOL_BURSTS[0]:]]
            futs.append(pool.submit(probe, priority="latency"))
            results = [f.result(timeout=600) for f in futs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {c.name: c.value for c in (k1, k2)}
            ticks = pool._ticks - ticks0
            stats = pool.stats
        finally:
            pool.close()
        tokens = [retired.get(id(f)) for f in futs]
        n_tok = sum(len(t) for t in tokens if t is not None)
        log(f"pool: {len(futs)} requests ({n_bulk} bulk of {sorted(set(seconds))} s + a 2 s "
            f"latency probe), {POOL_SLOTS} slots, ticks of {POOL_TICK}: wall {wall:.3f} s, "
            f"{len(futs) / wall:.2f} req/s, {n_tok / wall:.1f} generated tokens/s, {ticks} ticks, "
            f"tick_ms_p50 {stats.get('tick_ms_p50')} p90 {stats.get('tick_ms_p90')}, "
            f"admit groups {stats['admit_groups']} (mean {stats['mean_admit_group']}) on "
            f"{dev_name} ({power}); launches {launches}")
        for i, (toks, res) in enumerate(zip(tokens, results)):
            if toks is None:
                raise AssertionError(f"request {i} was not retired by the pool")
            if not (len(toks) == POOL_MAX_NEW or (toks and toks[-1] == eos)) or not res.text:
                raise AssertionError(f"request {i}: {len(toks)} tokens, text {res.text!r}")
        if pool._fb_thread is not None:
            raise AssertionError("a request went to the fallback worker")
        need = ticks * POOL_TICK * DECODE_PRODUCTS
        if launches["quant_matmul_plane_cuda"] < need:
            raise AssertionError(f"K2 launches {launches} below {need}")
        if launches["quant_matmul_cuda"] != 0:
            raise AssertionError(f"K1 ran in the plane phase: {launches}")
        # information: the solo path under the same kernel, for a sample
        sample = list(range(0, n_bulk, 3)) + [n_bulk]
        same = 0
        for i in sample:
            audio = probe if i == n_bulk else clips[i]
            solo = model.transcribe(audio, options=SamplingOptions(max_tokens=POOL_MAX_NEW))
            same += solo.text == results[i].text
        log(f"pool: transcripts equal to the solo path's (K2, batch 1, the model's int8 KV "
            f"where the pool's arena is bf16): {same} of {len(sample)}")
    finally:
        quant.KERNEL = saved
    return launches


def phase_beam_sampling(model, counters):
    import torch

    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

    rng = np.random.default_rng(6)
    clips = [(0.1 * rng.standard_normal(8 * 16000)).astype(np.float32) for _ in range(4)]
    n_gens = []
    finalize = model._finalize

    def capture(tokens, n_gen, *rest):
        n_gens.append((tokens.copy(), n_gen.copy()))
        return finalize(tokens, n_gen, *rest)

    model._finalize = capture
    try:
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        model.transcribe_batch(clips, options=SamplingOptions(max_tokens=32, beam=4))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.name: c.value for c in counters}
        _, n_gen = n_gens[-1]
        log(f"beam: 4 x 8 s, beam 4, 32 tokens, int8 KV: wall {wall:.3f} s, n_gen {n_gen.tolist()}, "
            f"launches {launches}")
        if (n_gen <= 0).any() or any(v <= 0 for v in launches.values()):
            raise AssertionError(f"beam: n_gen {n_gen}, launches {launches}")
        opts = SamplingOptions(max_tokens=32, temperature=0.8, top_k=50, repetition_penalty=1.1,
                               no_repeat_ngram=3)
        runs = []
        for _ in range(2):
            model.transcribe_batch(clips, options=opts, seed=7)
            runs.append(n_gens[-1][0])
        log(f"sampling: temperature 0.8, top-k 50, repetition 1.1, no-repeat 3-gram, seed 7 "
            f"twice: identical tokens {bool(np.array_equal(runs[0], runs[1]))}")
        if not np.array_equal(runs[0], runs[1]):
            raise AssertionError("sampling with one seed drew different tokens")
    finally:
        del model._finalize


def serve_requests(server, n_clips: int):
    """Start ``server`` on a free port, POST ``n_clips`` 8 s WAVs and GET
    /health concurrently, stop it; returns the answers and the wall time."""
    import asyncio
    import http.client
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from qwen3_asr_swift_tpu_torch.audio import wav_bytes

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(timeout=30)
        port = server._server.sockets[0].getsockname()[1]
        rng = np.random.default_rng(3)
        bodies = [wav_bytes((0.1 * rng.standard_normal(8 * 16000)).astype(np.float32), 16000)
                  for _ in range(n_clips)]

        def request(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            try:
                headers = {"Content-Type": "audio/wav"} if body is not None else {}
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_clips + 1) as pool:
            futs = [pool.submit(request, "POST", "/transcribe", b) for b in bodies]
            futs.append(pool.submit(request, "GET", "/health"))
            answers = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        for status, payload in answers[:n_clips]:
            if status != 200 or "text" not in payload:
                raise AssertionError(f"/transcribe answered {status} {payload}")
        status, payload = answers[n_clips]
        if status != 200 or payload.get("status") != "ok":
            raise AssertionError(f"/health answered {status} {payload}")
        return port, answers, wall
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()


def phase_serve(model):
    from qwen3_asr_swift_tpu_torch.serving import SlotPoolASR, SpeechServer, build_registry

    server = SpeechServer(build_registry(model), port=0)
    port, answers, wall = serve_requests(server, 4)
    log(f"serve: 4 x POST /transcribe (8 s WAV) + GET /health on port {port}: "
        f"statuses {[a[0] for a in answers]} in {wall:.1f} s; health {json.dumps(answers[4][1])}")

    server = SpeechServer(build_registry(model), port=0, scheduler="slotpool", max_batch=4)
    port, answers, wall = serve_requests(server, 4)
    batcher = server._batcher_for(model)
    served = batcher.stats["requests_served"] if isinstance(batcher, SlotPoolASR) else None
    log(f"serve (slotpool): 4 x POST /transcribe (8 s WAV) + GET /health on port {port}: "
        f"statuses {[a[0] for a in answers]} in {wall:.1f} s; pool served {served}, "
        f"stats {json.dumps(batcher.stats)}")
    if not isinstance(batcher, SlotPoolASR) or served < 4:
        raise AssertionError(f"slotpool server: batcher {type(batcher).__name__}, served {served}")


# --------------------------------------------------------------------------- #
# the rest of the Qwen3-ASR family: wire codec, loader, group-dot, VAD,
# streaming ASR, forced aligner

def greedy_tokens(model, clips, max_tokens):
    """(tokens, n_gen) of one ``transcribe_batch``, read where the model
    hands them to ``_finalize``."""
    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

    seen = []
    finalize = model._finalize

    def capture(tokens, n_gen, *rest):
        seen.append((tokens.copy(), n_gen.copy()))
        return finalize(tokens, n_gen, *rest)

    model._finalize = capture
    try:
        model.transcribe_batch(clips, options=SamplingOptions(max_tokens=max_tokens))
    finally:
        del model._finalize
    return seen[0]


def byte_tokenizer():
    from qwen3_asr_swift_tpu_torch.tokenizers.bpe import BPETokenizer, _bytes_to_unicode

    enc = _bytes_to_unicode()
    return {enc[b]: b for b in range(256)}, BPETokenizer({enc[b]: b for b in range(256)}, [])


def phase_codec(model, dev_name, power):
    """Build the native wire codec; encode the slice's staging buffer with
    it and with numpy: pcm4 and dpcm4 byte-identical, µ-law within one code
    on under 1 % of samples (the native µ-law rounds through a table)."""
    from qwen3_asr_swift_tpu_torch.audio import companding
    from qwen3_asr_swift_tpu_torch.runtime import native

    if native.wire_codec_library() is None:
        raise AssertionError("no g++ on this machine: the native wire codec cannot be built")
    # built at its first use (the step phase's staging, as a user's first
    # transcribe of over 65,536 samples would), or found built
    log(f"codec: g++ build {native.build_info['seconds']:.2f} s "
        f"({'found built' if native.build_info['cached'] else 'built at first use'}) → "
        f"{native.build_info['path']}")
    rng = np.random.default_rng(0)
    clips = [(0.1 * rng.standard_normal(SLICE_CLIP_S * SR)).astype(np.float32)
             for _ in range(SLICE_CLIPS)]
    stage, _ = model.staging_buffer(clips)
    for name in ("mulaw_encode_np", "pcm4_encode_np", "dpcm4_encode_np"):
        fn = getattr(companding, name)
        companding._native()
        t0 = time.perf_counter()
        nat = fn(stage)
        t_nat = time.perf_counter() - t0
        saved = companding._native_lib
        companding._native_lib = False
        try:
            t0 = time.perf_counter()
            ref = fn(stage)
            t_np = time.perf_counter() - t0
        finally:
            companding._native_lib = saved
        nat = nat if isinstance(nat, tuple) else (nat,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if name == "mulaw_encode_np":
            d = np.abs(nat[0].astype(np.int16) - ref[0].astype(np.int16))
            verdict = f"max code difference {d.max()}, on {100 * (d > 0).mean():.4f} % of samples"
            if d.max() > 1 or (d > 0).mean() >= 0.01:
                raise AssertionError(f"codec {name}: {verdict}")
        else:
            same = all(a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes()
                       for a, b in zip(nat, ref))
            verdict = f"byte-identical {same}"
            if not same:
                raise AssertionError(f"codec {name}: native and numpy outputs differ")
        log(f"codec {name[:-10]}: {stage.shape[0]} x {stage.shape[1]} samples (the slice's "
            f"staging buffer): native {1e3 * t_nat:.1f} ms, numpy {1e3 * t_np:.1f} ms on the host "
            f"of {dev_name} ({power}); {verdict}")


def phase_load(weights, dev_name, power):
    """Write a full-width 0.6B checkpoint in the published MLX-4bit layout
    (floats and the group scales and biases in bf16, packed 4-bit decoder
    codes, a byte-level vocab.json and merges.txt), load it with
    ``Qwen3ASR.from_pretrained`` on the card, and hold its greedy tokens
    against a model built in memory from the same arrays."""
    import dataclasses
    import json
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from qwen3_asr_swift_tpu_torch.core.params import (checkpoint_flat, round_floats,
                                                        save_checkpoint)
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import CONFIG_SMALL, Qwen3ASR, detect_config

    enc, dec = round_floats(weights)        # the values a bf16 checkpoint holds
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    model_dir = tmp / "Qwen3-ASR-0.6B-MLX-4bit"
    try:
        t0 = time.perf_counter()
        save_checkpoint(checkpoint_flat(enc, dec), model_dir)
        vocab, tok = byte_tokenizer()
        (model_dir / "vocab.json").write_text(json.dumps(vocab))
        (model_dir / "merges.txt").write_text("#version: 0.2\n")
        write_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in model_dir.iterdir())
        want_cfg = dataclasses.replace(CONFIG_SMALL, decoder=dataclasses.replace(
            CONFIG_SMALL.decoder, bits=4, group_size=64))
        if detect_config(str(model_dir)) != want_cfg:
            raise AssertionError(f"detect_config({model_dir.name}) is not CONFIG_SMALL at 4 bits")
        t0 = time.perf_counter()
        loaded = Qwen3ASR.from_pretrained(str(model_dir), device="cuda", **model_options())
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    built = build_model(enc, dec, "cuda", torch.bfloat16, tokenizer=tok)
    rng = np.random.default_rng(8)
    clips = [(0.1 * rng.standard_normal(8 * SR)).astype(np.float32) for _ in range(2)]
    got, want = greedy_tokens(loaded, clips, 32), greedy_tokens(built, clips, 32)
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    log(f"load: {size / 1e6:.1f} MB checkpoint written in {write_s:.1f} s, loaded to the card in "
        f"{load_s:.1f} s on {dev_name} ({power}); tokenizer {loaded.tokenizer is not None}; "
        f"greedy tokens of 2 x 8 s equal to the model built in memory: {same} "
        f"(n_gen {got[1].tolist()})")
    if not same or loaded.tokenizer is None:
        raise AssertionError("the loaded model's tokens differ from the in-memory model's")


def phase_groupdot(weights, counters, dev_name, power):
    """quant_compute="groupdot" at full width: the first decode step card vs
    host CPU, then 8 x 8 s clips, 32 tokens, int8 KV; only the LM head
    (packed) runs K1, every decode step runs K3."""
    import torch

    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

    phase_step(weights, label="groupdot step", quant_compute="groupdot")
    k1, k3 = counters
    model = build_model(*weights, "cuda", torch.bfloat16, quant_compute="groupdot")
    rng = np.random.default_rng(9)
    clips = [(0.1 * rng.standard_normal(8 * SR)).astype(np.float32) for _ in range(8)]
    model.transcribe_batch(clips[:2], options=SamplingOptions(max_tokens=2))   # warm-up
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    tokens, n_gen = greedy_tokens(model, clips, 32)
    torch.cuda.synchronize()
    launches = {c.name: c.value for c in counters}
    gens = {}
    for n in (2, 32):
        t = {}
        model.transcribe_batch(clips, options=SamplingOptions(max_tokens=n), timings=t)
        gens[n] = t["generate"]
    ms_step = 1e3 * (gens[32] - gens[2]) / 30
    log(f"groupdot: 8 x 8 s, 32 tokens, int8 KV: n_gen {n_gen.tolist()}, launches {launches}; "
        f"{ms_step:.2f} ms a decode step (generate at 32 tokens {gens[32]:.3f} s, at 2 "
        f"{gens[2]:.3f} s) on {dev_name} ({power})")
    # device time a decode step: the 32-token run less the 2-token run,
    # kernel by kernel, over the 30 steps between them
    prof = {n: device_times(lambda n=n: model.transcribe_batch(
        clips, options=SamplingOptions(max_tokens=n))) for n in (2, 32)}
    per_step = {k: (prof[32][0].get(k, 0.0) - prof[2][0].get(k, 0.0)) / 30e3
                for k in prof[32][0]}
    busy = sum(per_step.values())
    log(f"groupdot under the profiler: device {busy:.3f} ms a decode step, wall "
        f"{1e3 * (prof[32][1] - prof[2][1]) / 30:.3f} ms a step, on {dev_name} ({power})")
    for name, ms in sorted(per_step.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  device {ms:8.3f} ms a step  {name[:100]}")
    layers = model.cfg.decoder.num_layers
    steps = launches["decode_attention_int8"] // layers
    if (launches["decode_attention_int8"] <= 0 or launches["decode_attention_int8"] % layers
            or launches["quant_matmul_cuda"] != steps + 1 or (n_gen <= 0).any()):
        raise AssertionError(f"groupdot: K1 must run once a decode step and once in prefill (the "
                             f"LM head), K3 once a layer a step: {launches}, n_gen {n_gen}")
    del model


def vad_stream(seconds, seed):
    """Noise bursts of 1-3 s between stretches of near silence, from a seed."""
    rng = np.random.default_rng(seed)
    out, loud, total = [], True, 0
    while total < seconds * SR:
        n = int(rng.uniform(1.0, 3.0) * SR)
        out.append((0.3 if loud else 0.003) * rng.standard_normal(n).astype(np.float32))
        total += n
        loud = not loud
    return np.concatenate(out)[: seconds * SR].astype(np.float32)


def phase_vad(dev_name, power):
    """Silero VAD (random, seed 0) over a 60 s stream: the card's batch
    pass against the host CPU's, and chunk-by-chunk streaming on the card
    against its batch pass."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.silero_vad import SileroVAD

    stream = vad_stream(60, seed=11)
    vad, host = SileroVAD.init_random(0), SileroVAD.init_random(0, device="cpu")
    vad.speech_probabilities(stream[:SR])            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = vad.speech_probabilities(stream)
    batch_s = time.perf_counter() - t0
    host_probs = host.speech_probabilities(stream)
    err = float(np.abs(probs - host_probs).max())
    state, got = vad.new_stream(), []
    t0 = time.perf_counter()
    for i in range(len(probs)):
        state, prob = vad.process_chunk(state, stream[i * 512:(i + 1) * 512])
        got.append(prob)
    stream_s = time.perf_counter() - t0
    s_err = float(np.abs(np.array(got) - probs).max())
    n = len(probs)
    log(f"vad: 60 s, {n} chunks of 32 ms: card vs host max abs {err:.3e} (tol {VAD_PROB_TOL:g}); "
        f"streaming vs batch max abs {s_err:.3e} (tol {VAD_STREAM_TOL:g}); "
        f"{1e3 * stream_s / n:.3f} ms a chunk streaming, {1e3 * batch_s / n:.4f} ms a chunk in "
        f"the batch pass ({batch_s:.3f} s) on {dev_name} ({power}); probabilities "
        f"{probs.min():.4f}..{probs.max():.4f}")
    if not err <= VAD_PROB_TOL or not s_err <= VAD_STREAM_TOL:
        raise AssertionError(f"vad: card vs host {err}, streaming vs batch {s_err}")
    return vad, stream


def _find_span(stream, audio, start_s):
    """The offset of ``audio`` in ``stream`` within a sample of
    ``start_s``, or None."""
    s0 = int(round(start_s * SR))
    for off in (s0, s0 - 1, s0 + 1):
        if off >= 0 and np.array_equal(stream[off:off + len(audio)], audio):
            return off
    return None


def phase_stream(model, vad, stream, counters, dev_name, power):
    """StreamingASR over the slice's model and the VAD: a 20 s stream in
    100 ms pushes, 32 tokens an event. Random weights give no real speech,
    so the hysteresis thresholds are taken from the VAD's own probabilities
    on this stream (onset at their 60th percentile, offset at their 40th);
    the stream is the VAD phase's, not chosen to suit. Each final's audio
    must be the stream's span from its start through its end, and its text
    a direct ``transcribe`` of that span on the card."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import StreamingASR, StreamingASRConfig
    from qwen3_asr_swift_tpu_torch.models.silero_vad import VADConfig

    audio = stream[: 20 * SR]
    probs = vad.speech_probabilities(audio)
    onset, offset = (float(np.percentile(probs, q)) for q in (60, 40))
    cfg = StreamingASRConfig(max_tokens=32, vad=VADConfig(onset=onset, offset=offset))
    sasr = StreamingASR(model, vad, cfg)
    heard = []
    transcribe = model.transcribe

    def record(a, *args, **kw):
        res = transcribe(a, *args, **kw)
        heard.append((np.array(a, np.float32), res.text))
        return res

    model.transcribe = record
    events, push_ms, event_ms = [], [], []
    try:
        for c in counters:
            c.reset()
        piece = SR // 10
        for i in range(0, len(audio), piece):
            t0 = time.perf_counter()
            out = sasr.push(audio[i:i + piece])
            ms = 1e3 * (time.perf_counter() - t0)
            (event_ms if out else push_ms).append(ms)
            events += out
        t0 = time.perf_counter()
        tail = sasr.finish()
        if tail:
            event_ms.append(1e3 * (time.perf_counter() - t0))
        events += tail
        torch.cuda.synchronize()
        launches = {c.name: c.value for c in counters}
    finally:
        del model.transcribe
    partials = [e for e in events if not e.is_final]
    finals = [e for e in events if e.is_final]
    all_ms = push_ms + event_ms
    log(f"stream: 20 s in 100 ms pushes, onset {onset:.5f} / offset {offset:.5f}: "
        f"{len(partials)} partials, {len(finals)} finals, launches {launches}; ms a push p50 "
        f"{np.percentile(all_ms, 50):.2f} p90 {np.percentile(all_ms, 90):.2f}; pushes without "
        f"an event p50 {np.percentile(push_ms, 50):.2f} ms; push to event (the push that "
        f"emitted it, transcription included) mean {np.mean(event_ms or [0]):.1f} ms, max "
        f"{max(event_ms or [0]):.1f} ms on {dev_name} ({power})")
    if not partials or not finals:
        raise AssertionError(f"stream: {len(partials)} partials and {len(finals)} finals")
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"stream: a kernel did not run: {launches}")
    # each event transcribed its audio once, in order (one under 10 ms is
    # not transcribed and has no text)
    heard = iter(heard)
    for e in events:
        if not e.text:
            continue
        span_audio, text = next(heard)
        if text != e.text:
            raise AssertionError(f"event {e}: its transcription said {text!r}")
        if not e.is_final:
            continue
        # the stream from the segment's start, through its end and on to the
        # end of the push that was held while the VAD confirmed the silence
        off = _find_span(audio, span_audio, e.segment_start)
        if off is None or len(span_audio) < (e.segment_end - e.segment_start) * SR - 2:
            raise AssertionError(f"final {e}: its {len(span_audio)} samples are not the "
                                 f"stream's span from its start through its end")
        direct = transcribe(audio[off:off + len(span_audio)], max_tokens=32).text
        if direct != e.text:
            raise AssertionError(f"final {e}: a direct transcribe gives {direct!r}")
    log(f"stream: each of {len(finals)} finals is the stream's span from its start through "
        f"its end "
        f"({', '.join(f'{e.segment_start:.3f}-{e.segment_end:.3f} s' for e in finals)}) and "
        f"equals a direct transcribe of it")


def phase_align(dev_name, power):
    """The forced aligner at the published widths (ENCODER_ALIGNER,
    DECODER_SMALL packed 4-bit, 5000 classes), random from seed 0, fp32 on
    the card and on the host CPU: an 8 s clip against 23 words. The card's
    words must equal the host aligner's, slot classes taken from the host's
    logits except at near-ties. Random weights put the timestamps anywhere
    in the head's 400 s range, so the times are held to that range and to
    monotone order, not to the clip."""
    import dataclasses

    import torch

    from qwen3_asr_swift_tpu_torch.core.params import init_random_params
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import CONFIG_SMALL, Qwen3ForcedAligner
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr.aligner import slot_text
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr.config import ENCODER_ALIGNER
    from qwen3_asr_swift_tpu_torch.ops.quant import K1_LAUNCHES, KERNEL_MAX_ROWS

    cfg = dataclasses.replace(CONFIG_SMALL, encoder=ENCODER_ALIGNER, decoder=dataclasses.replace(
        CONFIG_SMALL.decoder, bits=4, group_size=64))
    t0 = time.perf_counter()
    enc, dec = init_random_params(cfg, 0, quant_bits=4)
    rng = np.random.default_rng(1)
    h = cfg.decoder.hidden_size
    head = {"kernel": (rng.standard_normal((h, cfg.classify_num), dtype=np.float32)
                       / np.float32(np.sqrt(h)))}
    _, tok = byte_tokenizer()
    card = Qwen3ForcedAligner(cfg, enc, dec, head, tok, device="cuda", dtype=torch.float32)
    host = Qwen3ForcedAligner(cfg, enc, dec, head, tok, device="cpu", dtype=torch.float32)
    log(f"align: weights and both aligners in {time.perf_counter() - t0:.1f} s")
    clip = (0.1 * np.random.default_rng(12).standard_normal(8 * SR)).astype(np.float32)
    slotted = slot_text(ALIGN_TEXT, tok, cfg.timestamp_id)
    got = card._slot_logits(clip, slotted).cpu()
    want = host._slot_logits(clip, slotted)
    rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    card.align(clip, ALIGN_TEXT)                     # warm-up
    torch.cuda.synchronize()
    K1_LAUNCHES.reset()
    t0 = time.perf_counter()
    words = card.align(clip, ALIGN_TEXT)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    k1 = K1_LAUNCHES.value
    a_pad = cfg.encoder.window_tokens                 # the 8 s bucket: one 800-frame window
    text_rows = 6 + len(slotted.token_ids)
    rows = 32 + a_pad + (-(-text_rows // 128) * 128)
    case = "at most 256 rows: K1" if rows <= KERNEL_MAX_ROWS else "over 256 rows: plain product"
    want_k1 = 4 * cfg.decoder.num_layers if rows <= KERNEL_MAX_ROWS else 0
    seg = cfg.timestamp_segment_time
    # the host aligner's words from its own logits, except at near-ties: a
    # slot whose host top-2 margin is within twice the slot's largest
    # card-vs-host logit gap may take either class, and takes the card's
    top2 = want.topk(2, dim=-1).values
    ties = (top2[:, 0] - top2[:, 1]) <= 2 * (got - want).abs().max(dim=-1).values
    differ = got.argmax(-1) != want.argmax(-1)
    raw = torch.where(ties, got.argmax(-1), want.argmax(-1)).tolist()
    host._raw_indices = lambda audio, slotted: raw
    host_words = host.align(clip, ALIGN_TEXT)
    starts = [w.start for w in words]
    inside = sum(w.end <= len(clip) / SR for w in words)
    log(f"align: {len(words)} words, prompt {rows} rows ({case}), K1 launches {k1}; slot "
        f"logits rel L2 card vs host {rel:.3e} (tol {ALIGN_TOL:g}); one align {ms:.1f} ms on "
        f"{dev_name} ({power}); {inside} of {len(words)} words end inside the 8 s clip "
        f"(random weights: the 5000-class head spans {cfg.classify_num * seg:.0f} s)")
    if not rel <= ALIGN_TOL:
        raise AssertionError(f"align: slot logits rel L2 {rel} > {ALIGN_TOL}")
    if len(words) != len(slotted.words) or k1 != want_k1:
        raise AssertionError(f"align: {len(words)} words, K1 launches {k1} (want {want_k1})")
    if starts != sorted(starts) or any(not 0 <= w.start <= w.end <= cfg.classify_num * seg
                                       for w in words):
        raise AssertionError(f"align: times not monotone or outside the head's range: {words}")
    log(f"align: {int(differ.sum())} of {len(raw)} slots take another class on the card than "
        f"on the host, {int(ties.sum())} slots are near-ties (host top-2 margin within twice "
        f"the card-vs-host gap)")
    if bool((differ & ~ties).any()):
        raise AssertionError(f"align: slots {torch.nonzero(differ & ~ties).flatten().tolist()} "
                             f"take another class on the card without a near-tie")
    if [(w.word, w.start, w.end) for w in words] != [(w.word, w.start, w.end)
                                                      for w in host_words]:
        raise AssertionError(f"align: the card's words differ from the host aligner's: "
                             f"{words} vs {host_words}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from qwen3_asr_swift_tpu_torch.audio.companding import WIRE_NATIVE_CALLS
    from qwen3_asr_swift_tpu_torch.device import resolve_device
    from qwen3_asr_swift_tpu_torch.ops import cuda_build
    from qwen3_asr_swift_tpu_torch.ops.attention_int8 import K3_LAUNCHES
    from qwen3_asr_swift_tpu_torch.ops.quant import K1_LAUNCHES, K2_LAUNCHES

    dev = resolve_device("cuda")
    dev_name = torch.cuda.get_device_name(0)
    card = card_line()
    power = card.split(",")[-1].strip()
    log(f"device: {dev_name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    cuda_build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({'cached' if cuda_build.build_info.get('cached') else 'nvcc'})"
        f" → {cuda_build.build_info.get('path')}")
    for line in cuda_build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    k1, k2, k3 = phase_k1(dev), phase_k2(dev), phase_k3(dev)
    weights = make_weights()
    phase_step(weights)
    model = build_model(*weights, "cuda", torch.bfloat16)
    phase_codec(model, dev_name, power)
    launches, _ = phase_slice(model, (K1_LAUNCHES, K3_LAUNCHES, WIRE_NATIVE_CALLS), dev_name,
                              power)
    k1["launches"] = launches["quant_matmul_cuda"]
    k3["launches"] = launches["decode_attention_int8"]
    k2["launches"] = phase_pool(model, (K1_LAUNCHES, K2_LAUNCHES), dev_name,
                                power)["quant_matmul_plane_cuda"]
    phase_beam_sampling(model, (K1_LAUNCHES, K3_LAUNCHES))
    phase_serve(model)
    phase_load(weights, dev_name, power)
    phase_groupdot(weights, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    vad, stream = phase_vad(dev_name, power)
    phase_stream(model, vad, stream, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    phase_align(dev_name, power)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    ref = [m for m in sys.modules if m == "qwen3_asr_swift_tpu" or m.startswith("qwen3_asr_swift_tpu.")]
    if ref:
        raise AssertionError(f"the JAX package was imported: {ref}")

    log(json.dumps({"kernels": [k1, k2, k3]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
