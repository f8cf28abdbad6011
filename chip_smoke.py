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
5. k3      — kernel K3 (int8-KV decode attention) against its plain version
             at B=32, Hq 16, Hkv 8, D 128, L 580 with holes in ``valid``.
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
K3_TOL = 1e-4   # max|err| / max|ref|: fp32 sum order over 580 keys, online softmax
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
    kernels_per_call) tuple per call: wall from CUDA events around the loop,
    launch gaps included; device time from the profiler (every kernel the
    call launched), or from CUDA events around each call where the profiler
    kept dropping events (``device_source`` says which); the most kernels
    per call that a profiler window showed."""
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
                        top)
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
                max(per_call))

    for i in range(warmup):
        for fn, sets in calls:
            fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    order = list(range(len(calls))) + list(reversed(range(len(calls))))
    out = [[0.0, 0.0, "profiler", 0.0] for _ in calls]
    for j in order:
        out[j][0] += wall(*calls[j]) / 2
    for j in order:
        ms, source, per_call = device(*calls[j])
        out[j][1] += ms / 2
        out[j][3] = max(out[j][3], per_call)
        if source != "profiler":
            out[j][2] = source
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
        (ms, dev_ms, source, per_call), (plain_ms, plain_dev_ms, _, _), (_, lib_dev_ms, _, _) = timed
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


def phase_k3(dev):
    import torch
    import torch.nn.functional as F

    from qwen3_asr_swift_tpu_torch.ops import attention_int8
    from qwen3_asr_swift_tpu_torch.ops.kv_cache import quantize_kv

    g = torch.Generator(device=dev).manual_seed(1)
    b, hq, hkv, length, d = 32, 16, 8, 580, 128

    def make():
        q = torch.randn((b, hq, 1, d), generator=g, device=dev).to(torch.bfloat16)
        kq, ks = quantize_kv(torch.randn((b, hkv, length, d), generator=g, device=dev))
        vq, vs = quantize_kv(torch.randn((b, hkv, length, d), generator=g, device=dev))
        valid = torch.rand((b, length), generator=g, device=dev) > 0.3
        valid[:, 448:] = False   # the unwritten decode rows
        valid[:, 40] = True
        return q, kq, ks, vq, vs, valid

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

    sets = input_sets(make, 2 * b * hkv * length * (d + 4))
    got = attention_int8.decode_attention_int8(*sets[0])
    ref = attention_int8.decode_attention_int8_ref(*sets[0])
    lib = sdpa(*library_args(*sets[0]))
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    lib_err, lib_rel = rel_err(lib, ref)
    lib_sets = [library_args(*st) for st in sets]
    timed = time_turns([(attention_int8.decode_attention_int8, sets),
                        (attention_int8.decode_attention_int8_ref, sets), (sdpa, lib_sets)])
    (ms, dev_ms, _, _), (plain_ms, plain_dev_ms, _, _), (_, lib_dev_ms, _, _) = timed
    from_events = [what for what, t in zip(("kernel", "plain", "library"), timed)
                   if t[2] != "profiler"]
    q_bytes = b * hq * d * sets[0][0].element_size()
    n_bytes = 2 * b * hkv * length * (d + 4) + q_bytes + b * length + b * hq * d * 4
    # bf16 q against an int8 cache, exact in bf16: priced at the bf16 tensor cores
    b_ms, b_by = bound(n_bytes, 4 * b * hq * length * d, PEAK_BF16_TC)
    log(f"K3 B={b} Hq={hq} Hkv={hkv} L={length} D={d} max_abs_err={err:.3e} rel={rel:.3e} "
        f"(tol {K3_TOL:g}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"device: kernel_ms={dev_ms:.4f} plain_ms={plain_dev_ms:.4f} library_ms={lib_dev_ms:.4f} "
        f"(sdpa fp32, enable_gqa={gqa}, rel {lib_rel:.1e}) bound_ms={b_ms:.4f} ({b_by}) "
        f"bound/kernel={b_ms / dev_ms:.3f} kernel/library={dev_ms / lib_dev_ms:.2f}")
    if not rel <= K3_TOL:
        raise AssertionError(f"K3: rel error {rel} > {K3_TOL}")
    return {"name": "decode_attention_int8", "route": "cuda",
            "source": "qwen3_asr_swift_tpu_torch/csrc/decode_attn_int8.cu",
            "replaces": "qwen3_asr_swift_tpu/ops/attention_pallas.py:33",
            "max_abs_err": err, "ms": 28 * ms, "plain_ms": 28 * plain_ms,
            "device_ms": 28 * dev_ms, "plain_device_ms": 28 * plain_dev_ms,
            "bound_ms": 28 * b_ms, "bound_by": b_by, "library_ms": 28 * lib_dev_ms,
            "device_source": device_source(from_events),
            "library_call": "scaled_dot_product_attention on fp32 q and the cache "
                            f"dequantized to fp32, boolean mask, enable_gqa={gqa}",
            "ms_per": "one decode step at batch 32 (28 layers), operands cold in L2"}


def make_weights():
    from qwen3_asr_swift_tpu_torch.core.params import init_random_params
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import CONFIG_SMALL

    t0 = time.perf_counter()
    enc, dec = init_random_params(CONFIG_SMALL, seed=0, quant_bits=4)
    log(f"weights: CONFIG_SMALL random seed 0, decoder packed 4-bit group 64 "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    return enc, dec


def build_model(enc, dec, device, dtype, **kw):
    import dataclasses

    import torch

    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import CONFIG_SMALL, Qwen3ASR

    cfg = dataclasses.replace(CONFIG_SMALL, decoder=dataclasses.replace(
        CONFIG_SMALL.decoder, bits=4, group_size=64))
    return Qwen3ASR.from_params(cfg, enc, dec, device=device, dtype=dtype,
                                kv_dtype=torch.int8, wire_dtype="dpcm4",
                                decode_chunk_tokens=15, quant_compute="packed",
                                audio_buckets_s=(8, 16, 32, 64), **kw)


def phase_step(weights):
    """Full-width prefill + first decode step, card (kernels) vs host CPU
    (plain versions), both fp32 with TF32 off."""
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
        model = build_model(*weights, where, torch.float32)
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
        log(f"step on {where}: {time.perf_counter() - t0:.1f} s")
        del model
    torch.backends.cudnn.allow_tf32 = True
    enc_rel = (torch.linalg.vector_norm(out["cuda"][0] - out["cpu"][0])
               / torch.linalg.vector_norm(out["cpu"][0])).item()
    rel = (torch.linalg.vector_norm(out["cuda"][1] - out["cpu"][1])
           / torch.linalg.vector_norm(out["cpu"][1])).item()
    same = (out["cuda"][1].argmax(-1) == out["cpu"][1].argmax(-1)).tolist()
    log(f"step: encoder rel L2 {enc_rel:.3e}; decode-step logits rel L2 {rel:.3e} "
        f"(tol {STEP_TOL:g}); argmax equal per clip {same}")
    if not rel <= STEP_TOL:
        raise AssertionError(f"decode-step logits rel L2 {rel} > {STEP_TOL}")


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

    # where the time goes (information): stage times with a sync at each
    # boundary, then the device's busy share under the profiler
    timings = {}
    model.transcribe_batch(clips, options=opts, timings=timings)
    log("slice stages (synced at boundaries): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.transcribe_batch(clips, options=opts)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    log(f"slice under the profiler: wall {prof_wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / prof_wall:.1f} %), idle {100 * (1 - busy / prof_wall):.1f} %")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")
    # per hand-written kernel, all its instances (K1's split sum with K1:
    # K2, which shares it, does not run here)
    for label, marks in (("K1", ("::quant_matmul_kernel<", "::split_sum(")),
                         ("K3", ("::decode_attn_int8_kernel<",))):
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

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
    launches, _ = phase_slice(model, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    k1["launches"] = launches["quant_matmul_cuda"]
    k3["launches"] = launches["decode_attention_int8"]
    k2["launches"] = phase_pool(model, (K1_LAUNCHES, K2_LAUNCHES), dev_name,
                                power)["quant_matmul_plane_cuda"]
    phase_beam_sampling(model, (K1_LAUNCHES, K3_LAUNCHES))
    phase_serve(model)
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
