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
             ``POST /transcribe`` (JSON bodies with a 64-token budget) and
             one ``GET /health`` with the group scheduler, and again with
             the slot pool, each through the batcher the server builds.

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
12. groupdot — ``quant_compute="groupdot"``: the decode step card vs host
               with every group-dot product teacher-forced (each product
               on the host's input within 1e-5, each input within 2^-6 of
               max |host|, the logits as in step; the free-running logits
               printed), 8 × 8 s clips at 32 tokens, K1 once a step
               (the packed LM head) and K3 every layer;
13. vad      — Silero VAD (random, seed 0) over a 60 s stream: card vs host
               within 1e-4, chunk-by-chunk streaming within 1e-5 of the batch;
14. stream   — ``StreamingASR`` over the slice's model and that VAD, 20 s in
               100 ms pushes: partials and finals, each final the stream's
               span and equal to a direct ``transcribe`` of it; K1, K3 run;
15. align    — ``Qwen3ForcedAligner`` at the published widths (5000 classes):
               slot logits card vs host within 5e-2 relative L2, monotone
               times, K1 only when the prompt has at most 256 rows.

Then Qwen3-TTS, at the 1.7B widths (talker 2048 × 28, code predictor
1024 × 5; random, seed 0; talker and code predictor packed 4-bit group 64):

16. tts    — the first frame's code0 logits and the code predictor's first
             group logits, card vs host CPU (fp32 both) within 5e-2
             relative L2; a greedy synthesis of 48 frames in bf16 under
             ``quant_compute="fused"`` (K1's launches must equal the count
             worked out from the code and the frames run) and
             ``"groupdot"`` (no K1): finite audio of frames × 1920 samples,
             frames/s, RTF, and the device ms a frame of the talker step,
             the code-predictor chain and the codec (profiler ranges); K1
             against its plain version at the frame loop's 1-row shapes,
             with its bound and ``torch.mm`` yardstick summed over a frame;
17. speak  — ``SpeechServer`` with ``asr`` and ``tts`` (the model's default
             sampling greedy, 16 frames): four concurrent ``POST /speak``
             under the group scheduler (``TTSBatcher``) and the slot pool
             (``SlotPoolTTS``), each batcher the server's own, each answer a
             24 kHz WAV; each pooled synthesis against the solo
             ``synthesize`` of its text: every logit vector up to the first
             code where they part within 5e-2 relative L2, and the codes
             equal or parting at a near-tie (the solo margin within twice
             the largest logit gap); no text → 400, no ``tts`` → 503;

Then the other TTS engines at their published widths (random, seed 0),
each with K1's and K3's counters read before and after (they must not
move: no packed product, no int8 cache):

17a. cosyvoice — CosyVoice3 ``CONFIG_05B`` (LLM 24 × 896, DiT 22 × 1024,
               HiFT 512), at most 150 speech tokens: cut to 2 LLM and 2 DiT
               layers, card vs host CPU with the same draws (every step's
               logits up to the first parting and the mel within 1e-4,
               tokens equal or parting at a near-tie, waveform within 1e-3,
               relative L2); the full model
               drawn on the card: tokens/s, device ms a token by range, flow
               and HiFT ms a second of audio, RTF, peak memory; one
               ``synthesize_stream`` and one bf16 ``synthesize``;
17b. vibevoice — VibeVoice ``CONFIG_05B`` (4 + 20 layers of 896, a 4-layer
               diffusion head, 20 DPM steps with CFG, the σ-VAE), 24 frames
               (EOS head biased off): at 2 + 2 layers, each frame's latent
               card vs host on a float64 run's history within 1e-4, the
               card no farther from float64 than 2x the host, the free run
               no farther than 4x, EOS decisions equal, the decode within
               1e-3; the
               full model on the card: frames/s against 7.5 Hz, device ms a
               frame (LM, diffusion, decode), RTF, peak memory;
               ``encode_voice`` on 3 s, then a voiced ``synthesize``;
17c. kokoro  — Kokoro ``CONFIG_82M`` (ALBERT 768 x 12 shared, hidden 512,
               decoder 1024, iSTFTNet 10·6 x hop 5), fp32, drawn on the card:
               card vs host CPU stage by stage with the same source noise
               (durations equal or parting at a half-integer near-tie; F0/N
               and the decoder's input within 1e-4 relative L2; the
               waveform no farther from a float64 run than 2x the host's);
               a timed ``synthesize`` of a 55-id text (bucket 64): RTF,
               device ms by range, the frame budget against the spoken
               frames, idle share, peak memory and the largest blocks live
               at it;
17d. voxcpm2 — VoxCPM2 ``CONFIG_2B`` (base LM 2048 x 28, residual 8, LocEnc
               and DiT 1024 x 12, the AudioVAE at 48 kHz), drawn on the
               card, stop head biased off, 32 patches (5.12 s): cut to 2 + 1
               + 1 + 1 layers at the published widths, card vs host CPU in
               fp32 (each step's patch within 1e-4 of max |host| up to the
               first FSQ parting, which must be a near-tie; ``n_steps``
               equal with the stop head live; the VAE decode within 1e-3 and
               no farther from a float64 decode than 2x the host's);
               the full model in bf16: patches/s against 6.25 Hz, device ms a
               patch by range, prefill, VAE ms a second of audio, RTF, idle
               share, peak memory; one cloned and one ``instruct`` synthesis;
17e. speak (engines) — ``POST /speak`` with ``engine`` ``cosyvoice``,
               ``vibevoice``, ``kokoro`` and ``voxcpm2`` under both
               schedulers: each through a ``TTSBatcher`` and equal to the
               direct ``synthesize``'s WAV;
Then the server's last three routes:

18. realtime — ``/v1/realtime`` on a server with the slice's ASR model and
               the 1.7B TTS model: a stdlib client (masked frames) appends
               8 s of PCM16 in 100 ms pieces and commits (the transcript
               must equal ``/transcribe``'s for the same samples at the same
               32-token budget, the model's default there), then
               ``conversation.item.create`` + ``response.create`` (the deltas
               must be the PCM16 of the model's own ``synthesize_stream``);
               K1 and K3 must run;
19. enhance  — DeepFilterNet3 at its published widths (random, seed 0) on
               10 s of noisy 48 kHz audio: card vs host within 1e-4 of max
               |host| (fp32), ``StreamingEnhancer`` in 100 ms pushes within
               1e-5 of the batch output, ``POST /enhance`` a WAV of the same
               length, ms a second of audio;
20. respond  — PersonaPlex ``CONFIG_7B`` with Mimi at its published widths,
               random weights drawn on the card, temporal stack and text head
               packed 4-bit: K1 at the frame's five shapes (rows 1, bf16 x)
               with bound and ``torch.mm`` yardstick summed over a frame; (a)
               cut to 2 temporal layers, fp32, the first frame's text and
               codebook-0 logits card vs host within 5e-2 relative L2; (b)
               the 7B in bf16, one greedy ``respond`` of 4 s with the default
               system prompt, 75 frames: K1's launches the count from the
               code (129 a frame, 128 for the 96-row prompt), frames/s, RTF,
               device ms a frame by range, peak device memory; (c)
               ``POST /respond``: a WAV, ``format: "json"`` with
               ``text_token_ids`` and the audio of a direct ``respond`` with
               the same seed, 503 without an ``s2s`` model;
21. cli      — ``python -m qwen3_asr_swift_tpu_torch.cli`` on the card with
               ``--random-weights``: transcribe, transcribe-batch, align,
               vad (silero, pyannote, firered), vad-stream, diarize,
               embed-speaker (WeSpeaker, CAM++), speak, denoise, separate,
               translate, respond, vibevoice, kokoro and voxcpm2, in
               parallel, each exit 0 with the reference's JSON keys and its
               wall printed; ``diarize --engine sortformer`` exits non-zero
               naming the roadmap.

Then the conversational paths (chat and agent run after realtime, while
the TTS model is still built; duplex after respond, on its 7B):

22. chat     — Qwen3.5 ``CONFIG_08B`` (hidden 1024, 18 DeltaNet + 6 gated
               attention layers, vocab 151,936), random weights drawn on the
               card, packed 4-bit group 64 (the tied table too): K1 at the
               token's 11 shapes (rows 1, bf16 x) with bound and yardstick
               summed over a token; cut to 2 layers in fp32, the first-step
               logits card vs host within 5e-2 relative L2; the 0.8B in bf16:
               64 greedy tokens, ``generate_ids_stream`` equal to
               ``generate_ids``, K1's launches the count from the code
               (packed products a row-block × steps), tokens/s, device ms a
               token by range;
23. agent    — one turn of ``VoicePipeline`` (the C++ engine built with g++)
               over Silero on the card, the slice's ASR (K1, K3), the chat
               model (64 tokens) and the 1.7B TTS (24 frames): no ERROR
               event; the transcript equal to a direct ``transcribe`` of the
               samples the STT adapter got, the reply to a direct ``chat`` of
               it, the audio chunks to a direct ``synthesize`` of the reply;
               end of speech → transcript, reply and first audio;
24. duplex   — ``PersonaPlex.realtime_session`` on phase respond's 7B over its
               4 s of user audio (50 frames), greedy with the repetition
               penalties off: streaming Mimi codes equal to the batch encode;
               agent codes and text equal to the offline ``_converse`` or
               parting at a near-tie; ``batch=2`` with two voice prompts
               against two single sessions; an int8-KV session; K1's launches
               128 + 129 a frame; push p50/p90, frames/s against 12.5 Hz,
               device ms a frame by range, peak memory at batch 1 and 2.

Then the speaker and VAD families, separation and translation (after
duplex, before cli; fp32 unless said; K1's and K3's counters must not
move; each phase prints its seconds):

25. pyannote  — segmentation-3.0 ``SEGMENTATION_30``: card vs host on 60 s
               (activity within 1e-4 of max |host|, VAD segments equal but
               at a near-tie frame); ``detect_speech`` of 5 min (59 windows
               of 10 s in one batched forward): windows/s, device ms by range
               (SincNet, BiLSTM, heads), loop iterations, idle, peak memory;
26. firered   — FireRedVAD ``CONFIG_FIRERED`` on 60 s (one pass) and
               150 s (the chunked path): card vs host within 1e-4, chunked
               vs one pass within 1e-5, ms a second of audio by path;
27. speaker   — WeSpeaker at the published widths (30 s; 40 × 1.5 s
               batched) and CAM++ ``CONFIG_CAMPPLUS`` (8 s; 8 clips): raw
               embeddings card vs host within 1e-4 relative L2, batch rows
               vs ``embed`` within 1e-5, ms an embedding, peak memory; then
               ``clone_voice`` on a CosyVoice ``CONFIG_05B`` at 2 + 2 layers
               with the card's CAM++ (the stored vector CAM++'s ``embed``);
28. diarize   — ``DiarizationPipeline`` (Silero with an energy decision laid
               over its random output, phase speaker's WeSpeaker) on 60 s of
               two synthetic voices: at least 20 windows, labels from the
               card's embeddings equal to the host's unless a merge distance
               lies within 1e-4 of the threshold; wall, ms a window;
29. separate  — Open-Unmix at ``init_umx_params``' defaults, 4 stems: card
               vs host on 10 s within 1e-4 of max |host|; 30 s at 44.1 kHz
               (1,292 frames): RTF, device ms by range (STFT, fc, BiLSTM,
               Wiener, iSTFT), loop iterations, idle, peak memory;
30. translate — MADLAD-400 ``CONFIG_3B``: at 2 + 2 layers in fp32, encoder
               card vs host within 1e-5, first-step logits within 1e-4
               relative L2, 32 greedy ids equal or parting at a near-tie;
               the 3B in bf16 (drawn on the card), a 48-id source, 64
               greedy tokens with EOS set outside the vocabulary for that
               run: tokens/s, encoder ms, device ms a token, idle, peak.

Weights are random at the full width of each configuration, drawn on the
card from a seeded ``torch.Generator`` (torch seed 0; packed there where a
phase packs), the slice's, the 1.7B TTS's and the aligner's included, and
host models take copies of the card's arrays. The
card-vs-host cuts of phases cosyvoice and vibevoice draw with numpy (seed
0). Each draw prints its seconds. The line before the last is ``{"kernels": [...]}`` (each
entry with its launches in the main path's run, its bound and its library
time); the last line is ``{"ok": true, "device": {...}}``. Imports nothing
of JAX nor of the JAX package, and checks so before the last lines.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest.mock import patch

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
# each group-dot product computed on the card from the host's input, of max
# |host output|: the int8 codes are the host's, the integer partials exact,
# only the fp32 sums over the groups taken in another order
GROUPDOT_PRODUCT_TOL = 1e-5
# each group-dot product's input, card vs host, of max |host input|, with
# the products teacher-forced: the decoder's activations are bf16 (the
# packed embedding rows), and each op between two products rounds to bf16
# on both sides in another order; 2^-6 is four bf16 ulps of the largest
GROUPDOT_INPUT_TOL = 2.0 ** -6
# the published peaks of one H100 SXM (dense), for the bounds: a product's
# operations are priced at the card's peak for its operand types, whatever
# pipe the kernel runs on today
HBM_BYTES_S = 3.35e12
PEAK_BF16_TC = 989e12       # bf16 tensor cores
PEAK_FP32 = 67e12           # float32 outside the tensor cores
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
SERVE_TOKENS = 64        # decode budget of each request in phase serve
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


def event_ms(fn, reps: int = 5):
    """Device ms of ``fn()`` from CUDA events around each of ``reps`` calls
    after a warm-up call (host gaps inside a call count): (least, median)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return min(times), float(np.median(times))


def stage_check(name, ranged_ms, fn, n_bytes, flops):
    """A profiled range's reading held up against the same stage alone
    under CUDA events and its bound (information: the profiler has lost a
    range's events now and then, PERF.md §7). Returns the log text."""
    least, median = event_ms(fn)
    b_ms, b_by = bound(n_bytes, flops, PEAK_FP32)
    note = "; the range reads below its bound: events lost" if ranged_ms < b_ms else ""
    return (f"{name} alone (CUDA events, 5 calls): least {least:.3f}, median {median:.3f} ms; "
            f"its range {ranged_ms:.3f} ms; bound {b_ms:.3f} ms ({b_by}, fp32 peak){note}")


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


def tree_numpy(tree):
    """Every tensor leaf of a tree as a host numpy array."""
    import torch

    if isinstance(tree, dict):
        return {k: tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_numpy(v) for v in tree]
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def make_weights(dev, seed: int = 0):
    """The slice's trees, drawn on the card from a seeded ``torch.Generator``
    with the decoder packed 4-bit group 64 there; and their host numpy
    copies (for the phases that also build a host model or write a
    checkpoint)."""
    import torch

    from qwen3_asr_swift_tpu_torch.core.params import init_random_params
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import CONFIG_SMALL

    t0 = time.perf_counter()
    trees = init_random_params(CONFIG_SMALL, seed, quant_bits=4, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = tree_numpy(trees)
    log(f"weights: CONFIG_SMALL drawn on the card from torch seed {seed}, decoder packed 4-bit "
        f"group 64 there, in {draw_s:.1f} s; host copy {time.perf_counter() - t0:.1f} s")
    return trees, host


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


def step_logits(weights, where, tok=None, **kw):
    """The full-width prefill + first decode step of 2 clips of 8 s on
    ``where``, fp32 (matmuls in full fp32, cuDNN's TF32 flag at its
    default: fp32 convs are tap matmuls); ``kw`` go to the model. Returns
    (audio tokens, logits, the first tokens), on the host; ``tok`` fixes
    the first tokens."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.qwen3_asr.decoder import decode_step
    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    clips = [(0.1 * rng.standard_normal(8 * 16000)).astype(np.float32) for _ in range(2)]
    model = build_model(*weights, where, torch.float32, **kw)
    with torch.inference_mode():
        st = model.prestage(clips)
        audio_tokens, n_audio = model._encode(st)
        prompt = model._prompt(st.b, None, None)
        state = model._gen_start(audio_tokens, n_audio, prompt, 4, SamplingOptions(max_tokens=4))
        if tok is None:
            tok = state.tokens[:, 0].cpu()
        logits, _ = decode_step(model.decoder_params, model.cfg.decoder, tok.to(model.device),
                                state.cache)
    return audio_tokens.float().cpu(), logits.float().cpu(), tok


def phase_step(weights, label="step", **kw):
    """Full-width prefill + first decode step, card (kernels) vs host CPU
    (plain versions), both fp32 (:func:`step_logits`); ``kw`` go to the
    model. Returns the relative L2 of the logits."""
    out = {}
    tok = None
    for where in ("cpu", "cuda"):
        t0 = time.perf_counter()
        *out[where], tok = step_logits(weights, where, tok, **kw)
        log(f"{label} on {where}: {time.perf_counter() - t0:.1f} s")
    enc_rel = rel_l2(out["cuda"][0], out["cpu"][0])
    rel = rel_l2(out["cuda"][1], out["cpu"][1])
    same = (out["cuda"][1].argmax(-1) == out["cpu"][1].argmax(-1)).tolist()
    log(f"{label}: encoder rel L2 {enc_rel:.3e}; decode-step logits rel L2 {rel:.3e} "
        f"(tol {STEP_TOL:g}); argmax equal per clip {same}")
    if not rel <= STEP_TOL:
        raise AssertionError(f"decode-step logits rel L2 {rel} > {STEP_TOL}")
    return rel


def groupdot_step(weights):
    """Phase step under ``quant_compute="groupdot"`` with every group-dot
    product teacher-forced: the host records each product's input and
    output; the card computes each of its products on the host's input,
    within ``GROUPDOT_PRODUCT_TOL`` of max |host output|, and goes on with
    the host's output. The rest of the model (encoder, norms, rope,
    attention over the int8 cache with K3) is held at each product's input,
    within ``GROUPDOT_INPUT_TOL`` of max |host input|, and the logits (the
    final norm, the packed LM head with K1) within ``STEP_TOL`` as phase
    step holds them: all without the int8 activation quantizer's flips,
    which turn every bf16 rounding that parts upstream into a whole code
    (ROADMAP §3 entry 11). The free-running logits are printed beside.
    Returns (forced rel L2, free rel L2, worst product, worst input)."""
    import torch

    from qwen3_asr_swift_tpu_torch.ops import quant

    real = quant.quant_matmul_groupdot
    calls = []

    def record(x, p):
        y = real(x, p)
        calls.append((x.cpu(), y.cpu()))
        return y

    t0 = time.perf_counter()
    with patch.object(quant, "quant_matmul_groupdot", record):
        _, host, tok = step_logits(weights, "cpu", quant_compute="groupdot")
    log(f"groupdot step on cpu: {time.perf_counter() - t0:.1f} s, {len(calls)} products")
    replay, worst, gaps = iter(calls), [0.0], []

    def forced(x, p):
        rx, ry = next(replay)
        if rx.shape != x.shape:
            raise AssertionError(f"groupdot step: product input {tuple(x.shape)} on the card, "
                                 f"{tuple(rx.shape)} on the host")
        gaps.append(((x.float().cpu() - rx).abs().max() / rx.abs().max()).item())
        y = real(rx.to(x.device), p).cpu()
        worst[0] = max(worst[0], ((y - ry).abs().max() / ry.abs().max()).item())
        return ry.to(x.device)

    t0 = time.perf_counter()
    with patch.object(quant, "quant_matmul_groupdot", forced):
        _, card, _ = step_logits(weights, "cuda", tok, quant_compute="groupdot")
    _, free, _ = step_logits(weights, "cuda", tok, quant_compute="groupdot")
    rel, rel_free = rel_l2(card, host), rel_l2(free, host)
    same = (card.argmax(-1) == host.argmax(-1)).tolist()
    log(f"groupdot step, every product teacher-forced: {len(gaps)} products on the card, each on "
        f"the host's input within {worst[0]:.3e} of max |host| (tol {GROUPDOT_PRODUCT_TOL:g}); "
        f"their inputs of max |host| at most {max(gaps):.3e} (tol {GROUPDOT_INPUT_TOL:g}); "
        f"decode-step logits rel L2 "
        f"{rel:.3e} (tol {STEP_TOL:g}), argmax equal per clip {same}; free-running (not held) "
        f"{rel_free:.3e}; card runs {time.perf_counter() - t0:.1f} s")
    if not (len(gaps) == len(calls) and worst[0] <= GROUPDOT_PRODUCT_TOL
            and max(gaps) <= GROUPDOT_INPUT_TOL and rel <= STEP_TOL):
        raise AssertionError(f"groupdot step: {len(gaps)} of {len(calls)} products, worst "
                             f"{worst[0]}, worst input {max(gaps)}, forced logits rel L2 {rel}")
    return rel, rel_free, worst[0], max(gaps)


def cuda_events(prof):
    """A finished profiler window's device events as (name, start µs, end
    µs), read from its raw trace: the event tree that ``prof.events()``
    builds costs about a millisecond of host an event."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def device_times(run):
    """Run ``run()`` once under the profiler: ({kernel name: device µs
    summed over its instances}, wall s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for name, start, end in cuda_events(prof):
        by_name[name] = by_name.get(name, 0.0) + end - start
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


def serve_requests(server, n_clips: int, max_tokens: int):
    """Start ``server`` on a free port, POST ``n_clips`` 8 s clips (JSON
    bodies, 16-bit PCM in base64, each with a decode budget of
    ``max_tokens``) and GET /health concurrently, stop it; returns the
    answers and the wall time."""
    import asyncio
    import base64
    import http.client
    import threading
    from concurrent.futures import ThreadPoolExecutor

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(timeout=30)
        port = server._server.sockets[0].getsockname()[1]
        rng = np.random.default_rng(3)
        clips = [np.clip(0.1 * rng.standard_normal(8 * 16000), -1, 1) for _ in range(n_clips)]
        bodies = [json.dumps({"audio_base64": base64.b64encode(
            (c * 32767).astype("<i2").tobytes()).decode(), "sample_rate": 16000,
            "max_tokens": max_tokens}).encode() for c in clips]

        def request(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            try:
                headers = {"Content-Type": "application/json"} if body is not None else {}
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
    """The model behind ``SpeechServer`` under each scheduler, with the
    batchers the server builds itself; each request carries a decode budget
    of ``SERVE_TOKENS`` (the depth of this path is cut: random weights
    decode to the budget, and the default 448 took 86-134 s of the run)."""
    from qwen3_asr_swift_tpu_torch.serving import (ContinuousBatcher, SlotPoolASR, SpeechServer,
                                                   build_registry)

    for scheduler, kind in (("group", ContinuousBatcher), ("slotpool", SlotPoolASR)):
        server = SpeechServer(build_registry(model), port=0, scheduler=scheduler, max_batch=4)
        port, answers, wall = serve_requests(server, 4, SERVE_TOKENS)
        batcher = server._batcher_for(model)
        served = batcher.stats["requests_served"] if isinstance(batcher, kind) else None
        log(f"serve ({scheduler}): 4 x POST /transcribe (8 s, {SERVE_TOKENS} tokens) + GET "
            f"/health on port {port}: statuses {[a[0] for a in answers]} in {wall:.1f} s; "
            f"{type(batcher).__name__} served {served}, stats {json.dumps(batcher.stats)}")
        if not isinstance(batcher, kind) or served != 4:
            raise AssertionError(f"{scheduler} server: batcher {type(batcher).__name__}, "
                                 f"served {served}")


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
    host CPU with its products teacher-forced (:func:`groupdot_step`),
    then 8 x 8 s clips, 32 tokens, int8 KV; only the LM head
    (packed) runs K1, every decode step runs K3."""
    import torch

    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

    groupdot_step(weights)
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


def phase_align(dev, dev_name, power):
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
    enc, dec = init_random_params(cfg, 0, quant_bits=4, device=dev)
    h = cfg.decoder.hidden_size
    head = {"kernel": torch.randn((h, cfg.classify_num), generator=torch.Generator(device=dev)
                                  .manual_seed(1), device=dev) / np.sqrt(h)}
    torch.cuda.synchronize()
    log(f"align weights: drawn on the card from torch seeds 0 and 1, decoder packed there, in "
        f"{time.perf_counter() - t0:.1f} s")
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


# --------------------------------------------------------------------------- #
# Qwen3-TTS: the frame loop at full width, /speak under both schedulers, the CLI

TTS_TOL = 5e-2          # first frame's logits, relative L2, card vs host CPU (phase step's limit)
TTS_FRAMES = 48         # 3.84 s of audio
TTS_TEXT = "Hello from one card. This sentence is spoken by the port."
# the profiled synthesis: the profiler's event tree takes ~4 s of host time
# a frame to build (on the H100 machine's host), so few frames
TTS_SPLIT_FRAMES = 4
SPEAK_FRAMES = 16
SPEAK_TEXTS = ("good morning", "the weather is fine today", "one two three four",
               "speech on a graphics card")
SPEAK_TOL = 5e-2        # pooled vs solo logits, relative L2 (phase step's limit)
SPEAK_WAV_TOL = 1e-3    # pooled vs solo waveform, of max |solo|, where the codes are equal


def tts_k1_launches(cfg, frames: int) -> int:
    """K1's launches in one greedy ``synthesize`` of ``frames`` frames
    (the first included) under ``quant_compute="fused"``, from the code:
    the prompt's text projection (fc1 and fc2, for the text rows and for
    the three special tokens), the talker prefill and each talker step (qkv,
    o, gate_up and down a layer, and the codec head), and each frame's code
    predictor chain (15 forwards of the input projection where the config
    has one, and qkv, o, gate_up and down a layer). Every product of the
    1.7B config packs; all have at most 256 rows."""
    t, c = cfg.talker, cfg.code_predictor
    talker = 4 * t.num_layers + 1
    chain = (c.num_code_groups - 1) * (4 * c.num_layers + int(c.needs_projection))
    return 2 * 2 + frames * (talker + chain)


def tts_first_frame(model, text, code0=None):
    """The first frame's code0 logits and the code predictor's first group
    logits (fp32, host); the chain is fed ``code0`` when given, else the
    greedy code0 of these logits."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.qwen3_tts.code_predictor import cp_prefill
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts.model import TTSSamplingConfig, sample_code0
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts.talker import (embed_codec,
                                                                   make_talker_cache,
                                                                   talker_prefill)

    tcfg, dev = model.cfg.talker, model.device
    with torch.inference_mode():
        prefill, _, _, p_len, _, p_block, _ = model._build_prompt_fused(text, "english", None)
        cache = make_talker_cache(tcfg, 1, p_block, model.dtype, device=dev)
        valid = torch.arange(p_block, device=dev)[None] < p_len
        logits, hidden, _ = talker_prefill(model.talker_params, tcfg, prefill, valid, cache)
        if code0 is None:
            ring = torch.full((1, 64), -1, dtype=torch.int64, device=dev)
            code0 = int(sample_code0(logits[:, p_len - 1], ring,
                                     TTSSamplingConfig(temperature=0.0, top_k=0), None)[0])
        cp0, _, _ = cp_prefill(model.cp_params, model.cfg.code_predictor, hidden[:, p_len - 1],
                               embed_codec(model.talker_params,
                                           torch.tensor([code0], device=dev)))
    return logits[0, p_len - 1].float().cpu(), cp0[0].float().cpu(), code0


def tree_to(tree, device, dtype=None):
    """Every tensor leaf of a tree on ``device``, its float leaves in
    ``dtype`` where given."""
    import torch

    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device, dtype) for v in tree]
    if not isinstance(tree, torch.Tensor):
        return tree
    return tree.to(device, dtype if dtype is not None and tree.is_floating_point() else None)


def peak_tensors(run, top: int = 6):
    """Run ``run()`` once with the caching allocator's history on. Returns
    (the peak of what it allocated and had not yet freed, in bytes, and the
    ``top`` largest blocks live at that peak as (bytes, the innermost frame
    of the port that allocated it))."""
    import torch

    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    try:
        run()
        torch.cuda.synchronize()
        events = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)

    def replay(upto):
        live, cur, peak, at = {}, 0, 0, 0
        for i, e in enumerate(events[:upto]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                cur += e["size"]
            elif e["action"] == "free_completed" and e["addr"] in live:
                cur -= live.pop(e["addr"])["size"]
            if cur > peak:
                peak, at = cur, i
        return live, peak, at

    _, peak, at = replay(len(events))
    live, _, _ = replay(at + 1)

    def where(e):
        for f in e.get("frames", []):
            if "qwen3_asr_swift_tpu_torch" in f["filename"]:
                return f"{f['filename'].split('qwen3_asr_swift_tpu_torch/')[-1]}:{f['line']} {f['name']}"
        return "outside the port"
    blocks = sorted(live.values(), key=lambda e: -e["size"])[:top]
    return peak, [(e["size"], where(e)) for e in blocks]


def ranged(name, fn, when=None):
    """``fn`` inside a profiler range ``name`` (or ``when(*args)``'s name)."""
    from torch.profiler import record_function

    def run(*a, **kw):
        with record_function(when(*a) if when else name):
            return fn(*a, **kw)
    return run


WINDOW_OPENER = "(opener)"    # the range of the spin kernels that open a profiled window


def range_device_ms(run, prefix: str, by_range=None):
    """Run ``run()`` once under the profiler. Each kernel's device time goes
    to the innermost ``record_function`` range (named ``prefix...``) whose
    span on the device holds the kernel's start, else to "other". The
    window opens with 64 spin kernels (≈ 10 ms) in a range of their own,
    left out of every result: late in a run that has profiled many windows,
    the profiler has lost a window's first events, its whole first range
    with them. Returns ({range: device ms}, {range: kernels}, {kernel name:
    device µs}, wall s); ``by_range``, a dict when given, receives {range:
    {kernel name: device µs}}."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(prefix + WINDOW_OPENER):
            for _ in range(64):
                torch.cuda._sleep(300_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, kernels = [], []
    for name, start, end in cuda_events(prof):
        if name.startswith(prefix):     # the range's own span on the device timeline
            spans.append((start, end, name[len(prefix):]))
        else:
            kernels.append((name, start, end))
    spans.sort()
    starts = [sp[0] for sp in spans]
    parent, open_ = [], []          # each span's enclosing span (-1: none)
    for j, (start, _, _) in enumerate(spans):
        while open_ and spans[open_[-1]][1] <= start:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(j)
    ms, count, by_kernel = {}, {}, {}
    for kernel, start, end in kernels:
        us = end - start
        i = bisect.bisect_right(starts, start) - 1
        while i >= 0 and start >= spans[i][1]:
            i = parent[i]
        name = spans[i][2] if i >= 0 else "other"
        if name == WINDOW_OPENER or kernel.startswith("spin_kernel"):
            continue
        by_kernel[kernel] = by_kernel.get(kernel, 0.0) + us
        ms[name] = ms.get(name, 0.0) + us / 1e3
        count[name] = count.get(name, 0) + 1
        if by_range is not None:
            into = by_range.setdefault(name, {})
            into[kernel] = into.get(kernel, 0.0) + us
    return ms, count, by_kernel, wall


def tts_split(model, text, sampling):
    """One ``synthesize`` under the profiler with the talker prefill, the
    talker steps, the code predictor chains and the codec decode in ranges
    of their own: ({range: device ms}, {kernel: device µs}, wall s, frames
    run, frames decoded)."""
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts import model as model_mod

    names = ("talker_prefill", "talker_step", "predict_codebooks")
    decoded = []
    decode = ranged("tts.codec", model.codec.decode_frames)
    wrapped = {k: ranged(f"tts.{k}", getattr(model_mod, k)) for k in names}
    with patch.multiple(model_mod, **wrapped), patch.object(
            model.codec, "decode_frames", lambda codes, n: decoded.append(n) or decode(codes, n)):
        ms, _, kernels, wall = range_device_ms(lambda: model.synthesize(text, sampling=sampling),
                                               "tts.")
    return ms, kernels, wall, model.last_loop["frames_run"], decoded[0]


#: K1's products on the 1.7B frame loop: (name, in, out, calls a frame)
TTS_K1_SHAPES = [("talker qkv", 2048, 4096, 28), ("talker o", 2048, 2048, 28),
                 ("talker gate_up", 2048, 12288, 28), ("talker down", 6144, 2048, 28),
                 ("codec head", 2048, 3072, 1), ("cp proj", 2048, 1024, 15),
                 ("cp qkv", 1024, 4096, 75), ("cp o", 2048, 1024, 75),
                 ("cp gate_up", 1024, 6144, 75), ("cp down", 3072, 1024, 75)]


def tts_k1_frame(dev, iters: int = 20):
    return k1_frame(dev, TTS_K1_SHAPES, "tts", "1.7B", iters)


def k1_frame(dev, shapes, what: str, model: str, iters: int = 20):
    """K1 at a frame loop's ``shapes`` (rows 1, bf16 x, 4-bit group 64, as a
    solo synthesis or response gives them) against its plain version, and
    the device time a call of K1, of the plain version and of the
    ``torch.mm`` yardstick, operands cycled so they are cold in L2, from one
    profiler window; with the bound, summed over a frame's calls. A shape
    whose window shows no kernel of a call is "not measured" (None)."""
    import torch
    from torch.profiler import record_function

    from qwen3_asr_swift_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(11)
    cases, worst = [], 0.0
    for name, d_in, d_out, per_frame in shapes:
        def make():
            p = {"codes": torch.randint(-2**31, 2**31 - 1, (d_out, d_in // 8), generator=g,
                                        device=dev, dtype=torch.int32),
                 "scales": torch.rand((d_out, d_in // 64), generator=g, device=dev) * 0.02,
                 "biases": (torch.rand((d_out, d_in // 64), generator=g, device=dev) - 0.5) * 0.2}
            return torch.randn((1, d_in), generator=g, device=dev).to(torch.bfloat16), p

        w_bytes = d_out * (d_in // 2 + 2 * 4 * d_in // 64)
        sets = input_sets(make, w_bytes)
        err, rel = rel_err(quant.quant_matmul_cuda(*sets[0]), quant.quant_matmul(*sets[0]))
        if not rel <= K1_TOL:
            raise AssertionError(f"K1 {what} {name}: rel error {rel} > {K1_TOL}")
        worst = max(worst, err)
        lib = [k1_library(*st)[1] for st in sets[:4]]
        cases.append((name, d_in, d_out, per_frame, sets, lib, w_bytes))

    def run(prefix):
        for name, _, _, _, sets, lib, _ in cases:
            for label, fn, args in (("k1", quant.quant_matmul_cuda, sets),
                                    ("plain", quant.quant_matmul, sets), ("lib", torch.mm, lib)):
                with record_function(f"{prefix}{label}.{name}"):
                    for i in range(iters):
                        fn(*args[i % len(args)])

    run("warm.")
    torch.cuda.synchronize()
    # a first pass inside the window too: the profiler has dropped the
    # first events of a window (the first range has come back short)
    ms, count, _, _ = range_device_ms(lambda: (run("warm."), run("k1f.")), "k1f.")
    frame = {"device_ms": 0.0, "plain_device_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name, d_in, d_out, per_frame, _, _, w_bytes in cases:
        b_ms, _ = bound(w_bytes + 2 * d_in + 4 * d_out, 2 * d_out * d_in, K1_PEAK["bfloat16"])
        got = {label: (ms[f"{label}.{name}"] / iters if count.get(f"{label}.{name}", 0) >= iters
                       else None) for label in ("k1", "plain", "lib")}
        log(f"K1 {what} {name:14s} rows=1 in={d_in:5d} out={d_out:5d} x=bfloat16 calls/frame="
            f"{per_frame:2d} device: kernel_ms={got['k1']} plain_ms={got['plain']} "
            f"library_ms={got['lib']} bound_ms={b_ms:.4f} (bytes)")
        for key, label in (("device_ms", "k1"), ("plain_device_ms", "plain"),
                           ("library_ms", "lib")):
            frame[key] = None if got[label] is None or frame[key] is None else \
                frame[key] + per_frame * got[label]
        frame["bound_ms"] += per_frame * b_ms
    log(f"K1 {what} per frame ({model}, rows 1, bf16 x; profiler): device kernel_ms "
        f"{frame['device_ms']} plain_ms {frame['plain_device_ms']} library_ms "
        f"{frame['library_ms']} bound_ms {frame['bound_ms']:.4f}")
    return dict(frame, max_abs_err=worst, bound_by="bytes")


def phase_tts(dev, k1_counter, dev_name, power):
    """Qwen3-TTS at the published 1.7B widths (random, seed 0; talker and
    code predictor packed 4-bit group 64 on the card): the first frame's
    logits card vs host CPU (fp32 both), then a greedy synthesis of
    ``TTS_FRAMES`` frames in bf16 under ``quant_compute="fused"`` (K1's
    launches must equal ``tts_k1_launches``) and ``"groupdot"`` (no K1).
    Returns (the bf16 fused model, K1's launches under fused, K1's frame
    timing)."""
    import dataclasses

    import torch

    from qwen3_asr_swift_tpu_torch.models.qwen3_tts import CONFIG_17B, Qwen3TTS, TTSSamplingConfig
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts.code_predictor import init_cp_params
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts.codec import init_codec_params
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts.talker import init_talker_params

    cfg = CONFIG_17B
    _, tok = byte_tokenizer()
    k1_frame = tts_k1_frame(dev)
    t0 = time.perf_counter()
    rng = torch.Generator(device=dev).manual_seed(0)
    weights = (init_talker_params(rng, cfg.talker), init_cp_params(rng, cfg.code_predictor),
               init_codec_params(rng, cfg.codec))
    torch.cuda.synchronize()
    log(f"tts weights: CONFIG_17B (talker 2048 x 28, CP 1024 x 5, codec decoder) drawn on the "
        f"card from torch seed 0 in {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ref32 = Qwen3TTS(cfg, *weights, device=dev, dtype=torch.float32, tokenizer=tok,
                     quant_bits=4, quant_compute="fused")
    torch.cuda.synchronize()
    log(f"tts: packed 4-bit group 64 on the card in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # the host takes the card's packed trees (packing 1.7B on the host would
    # take a minute); already fused, they pass through the constructor
    host = Qwen3TTS(cfg, tree_to(ref32.talker_params, "cpu"), tree_to(ref32.cp_params, "cpu"),
                    tree_to(ref32.codec.params, "cpu"), device="cpu", dtype=torch.float32,
                    tokenizer=tok, quant_compute="fused")
    h_code, h_cp, code0 = tts_first_frame(host, TTS_TEXT)
    del host
    log(f"tts first frame on the host CPU: {time.perf_counter() - t0:.1f} s")
    c_code, c_cp, c_code0 = tts_first_frame(ref32, TTS_TEXT, code0)
    rels = [(torch.linalg.vector_norm(c - h) / torch.linalg.vector_norm(h)).item()
            for c, h in ((c_code, h_code), (c_cp, h_cp))]
    log(f"tts first frame, card vs host (fp32): code0 logits rel L2 {rels[0]:.3e}, CP group-0 "
        f"logits rel L2 {rels[1]:.3e} (tol {TTS_TOL:g}); greedy code0 host {code0} card "
        f"{c_code0}")
    if not max(rels) <= TTS_TOL:
        raise AssertionError(f"tts first-frame logits rel L2 {rels} > {TTS_TOL}")

    del ref32
    fused, groupdot = (Qwen3TTS(cfg, *weights, device=dev, dtype=torch.bfloat16, tokenizer=tok,
                                quant_bits=4, quant_compute=qc) for qc in ("fused", "groupdot"))
    del weights
    sampling = TTSSamplingConfig(temperature=0.0, top_k=0, max_frames=TTS_FRAMES)
    fused_launches = None
    for label, m in (("fused", fused), ("groupdot", groupdot)):
        m.synthesize("warm up", sampling=dataclasses.replace(sampling, max_frames=4))
        seen = []
        decode = m.codec.decode_frames
        m.codec.decode_frames = lambda codes, n: seen.append(n) or decode(codes, n)
        torch.cuda.synchronize()
        k1_counter.reset()
        t0 = time.perf_counter()
        out = m.synthesize(TTS_TEXT, sampling=sampling)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k1_counter.value
        del m.codec.decode_frames
        frames_run, (n,) = m.last_loop["frames_run"], seen
        want = tts_k1_launches(cfg, frames_run) if label == "fused" else 0
        audio_s = len(out.samples) / out.sample_rate
        log(f"tts {label}: {n} frames ({frames_run} run, {m.last_loop['done_reads']} host reads "
            f"of done), {audio_s:.2f} s of audio in {wall:.3f} s: {frames_run / wall:.1f} "
            f"frames/s, RTF {wall / audio_s:.3f} on {dev_name} ({power}); K1 launches "
            f"{launches}, from the code {want}")
        if len(out.samples) != n * 1920 or not np.isfinite(out.samples).all() or n == 0:
            raise AssertionError(f"tts {label}: {len(out.samples)} samples for {n} frames, "
                                 f"finite {np.isfinite(out.samples).all()}")
        if launches != want:
            raise AssertionError(f"tts {label}: K1 launched {launches} times, the code says "
                                 f"{want}")
        if label == "fused":
            fused_launches = launches
        ranges, kernels, prof_wall, run_f, dec_n = tts_split(
            m, TTS_TEXT, dataclasses.replace(sampling, max_frames=TTS_SPLIT_FRAMES))
        busy = sum(kernels.values()) / 1e3
        k1_ms = sum(v for k, v in kernels.items()
                    if "::quant_matmul_kernel<" in k or "::split_sum(" in k) / 1e3
        log(f"tts {label} under the profiler ({run_f} frames): wall {prof_wall:.3f} s, device "
            f"busy {busy:.2f} ms (idle {100 * (1 - busy / 1e3 / prof_wall):.1f} %); device ms a "
            f"frame: talker step {ranges.get('talker_step', 0.0) / max(run_f - 1, 1):.3f}, CP "
            f"chain {ranges.get('predict_codebooks', 0.0) / run_f:.3f}, codec "
            f"{ranges.get('codec', 0.0) / dec_n:.3f}, all {busy / run_f:.3f}; talker prefill "
            f"{ranges.get('talker_prefill', 0.0):.3f} ms once, outside the ranges "
            f"{ranges.get('other', 0.0):.3f} ms; K1 {k1_ms / run_f:.3f} ms a frame; wall a frame "
            f"{1e3 * wall / frames_run:.1f} ms unprofiled; on {dev_name} ({power})")
        for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
            log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")
    del groupdot
    return fused, fused_launches, k1_frame


class LogitLog:
    """The logits each frame's samplers saw, per thread: a record starts at
    a frame's code0 sampling and collects that frame's 15 CP group logits."""

    def __init__(self):
        import threading

        self.tls = threading.local()
        self.frames = []

    def start(self, logits, **meta):
        rec = dict(meta, code0=logits.float().cpu().clone(), cp=[])
        self.frames.append(rec)
        self.tls.cur = rec

    def cp(self, logits):
        cur = getattr(self.tls, "cur", None)
        if cur is not None:
            cur["cp"].append(logits.float().cpu().clone())


def first_parting(solo_codes, pool_codes):
    """(frame, group) of the first code where two [n, 16] code lists part, or None."""
    for f in range(min(len(solo_codes), len(pool_codes))):
        for g in range(16):
            if solo_codes[f][g] != pool_codes[f][g]:
                return f, g
    if len(solo_codes) != len(pool_codes):
        return min(len(solo_codes), len(pool_codes)), 0
    return None


def phase_speak(asr, tts, dev_name, power):
    """``SpeechServer`` with ``asr`` and ``tts`` registered, the model's
    default sampling set to greedy with a ``SPEAK_FRAMES`` cap (a /speak
    body carries no sampling; the server's batchers use the model's): four
    concurrent ``POST /speak`` under the group scheduler (``TTSBatcher``)
    and under the slot pool (``SlotPoolTTS``), each batcher the one the
    server builds, each answer a 24 kHz WAV. Each pooled synthesis is held
    against the solo ``synthesize`` of its text: every logit vector the
    pool's samplers saw up to the first code where the two part (all of
    them where none does) within ``SPEAK_TOL`` relative L2 of the solo
    path's, and the codes identical or parting at a near-tie (the solo
    path's margin between its code and the pool's within twice the largest
    logit gap there). ``/speak`` with no text → 400; a server with no
    ``tts`` → 503."""
    import asyncio
    import http.client
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from qwen3_asr_swift_tpu_torch.audio.io import read_wav, wav_bytes
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts import TTSSamplingConfig
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts import code_predictor as cp_mod
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts import model as model_mod
    from qwen3_asr_swift_tpu_torch.serving import (SlotPoolTTS, SpeechServer, TTSBatcher,
                                                   build_registry)
    from qwen3_asr_swift_tpu_torch.serving import ttspool as pool_mod
    import torch

    greedy = TTSSamplingConfig(temperature=0.0, top_k=0, max_frames=SPEAK_FRAMES)

    def serve(server, bodies):
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever, daemon=True)
        thread.start()
        try:
            asyncio.run_coroutine_threadsafe(server.start(), loop).result(timeout=30)
            port = server._server.sockets[0].getsockname()[1]

            def ask(body):
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                try:
                    conn.request("POST", "/speak", body=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    return resp.status, resp.getheader("Content-Type", ""), resp.read()
                finally:
                    conn.close()

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=len(bodies)) as ex:
                answers = list(ex.map(ask, bodies))
            return answers, time.perf_counter() - t0
        finally:
            asyncio.run_coroutine_threadsafe(server.stop(), loop).result(timeout=120)
            loop.call_soon_threadsafe(loop.stop)
            thread.join(timeout=30)
            loop.close()

    def check_wavs(label, answers):
        wavs = []
        for status, ctype, body in answers:
            if status != 200 or not ctype.startswith("audio/wav"):
                raise AssertionError(f"speak ({label}): /speak answered {status} {body[:200]}")
            audio, rate = read_wav(body)
            if rate != 24000 or len(audio) == 0 or len(audio) % 1920:
                raise AssertionError(f"speak ({label}): {len(audio)} samples at {rate} Hz")
            wavs.append(audio)
        return wavs

    # the solo reference of each text, with the logits its samplers saw
    log_ = LogitLog()
    saved = (model_mod.sample_code0, cp_mod.sample_token, pool_mod.sample_code0)

    def solo_code0(logits, ring, sampling, gen):
        log_.start(logits, kind=getattr(log_.tls, "kind", "solo"),
                   text=getattr(log_.tls, "text", None))
        return saved[0](logits, ring, sampling, gen)

    def cp_token(logits, opts, gen=None, *a, **kw):
        log_.cp(logits)
        return saved[1](logits, opts, gen, *a, **kw)

    model_mod.sample_code0, cp_mod.sample_token = solo_code0, cp_token
    default_sampling, tts.sampling = tts.sampling, greedy
    solo = {}
    try:
        decode = tts.codec.decode_frames
        for text in SPEAK_TEXTS:
            log_.tls.text = text
            seen = []
            tts.codec.decode_frames = lambda codes, n: seen.append(
                codes[0, :n].cpu().numpy()) or decode(codes, n)
            try:
                wav = tts.synthesize(text, sampling=greedy).samples
            finally:
                del tts.codec.decode_frames
            solo[text] = (seen[0] if seen else np.zeros((0, 16), np.int64), wav)
        # per text, frame f's samplers are record f
        solo_logs = {t: [r for r in log_.frames if r["text"] == t] for t in SPEAK_TEXTS}
        log_.frames = []
        log_.tls.text = None

        registry = build_registry(asr, tts=tts)
        group = SpeechServer(registry, port=0, max_batch=4)
        answers, wall = serve(group, [{"text": t} for t in SPEAK_TEXTS])
        check_wavs("group", answers)
        batcher = group._tts_batcher_for(tts)
        log(f"speak (group): 4 x POST /speak, {SPEAK_FRAMES}-frame cap: statuses "
            f"{[a[0] for a in answers]} in {wall:.2f} s on {dev_name} ({power}); "
            f"{type(batcher).__name__} {json.dumps(batcher.stats)}")
        if not isinstance(batcher, TTSBatcher) or batcher.stats["requests_served"] != 4:
            raise AssertionError(f"speak (group): batcher {type(batcher).__name__} "
                                 f"{batcher.stats}")

        pool_codes = {}
        slot = SpeechServer(registry, port=0, scheduler="slotpool", max_batch=4)
        pool = slot._tts_batcher_for(tts)    # built by the server, as a request would
        if not (isinstance(pool, SlotPoolTTS) and pool.slots == 4 and pool.sampling == greedy
                and pool.oversize == "fallback"):
            raise AssertionError(f"speak (slotpool): the server built {type(pool).__name__} "
                                 f"{getattr(pool, 'slots', None)} slots, sampling "
                                 f"{getattr(pool, 'sampling', None)}")
        texts_of = {}
        admit, retire = pool._admit_one, pool._retire

        def admit_one(req):
            texts_of[id(req.fut)] = req.text
            log_.tls.kind, log_.tls.text = "first", req.text
            return admit(req)

        def retire_(s):
            live = pool._live[s]
            pool_codes[texts_of[id(live.fut)]] = np.stack(live.frames) if live.frames else \
                np.zeros((0, 16), np.int64)
            return retire(s)

        def tick_code0(logits, ring, sampling, gen):
            owners = {s: texts_of[id(lv.fut)] for s, lv in pool._live.items()}
            log_.start(logits, kind="tick", steps=pool._state.step.cpu().numpy().copy(),
                       owners=owners,
                       live=(pool._state.active & ~pool._state.done).cpu().numpy())
            return saved[2](logits, ring, sampling, gen)

        pool._admit_one, pool._retire, pool_mod.sample_code0 = admit_one, retire_, tick_code0
        answers, wall = serve(slot, [{"text": t} for t in SPEAK_TEXTS])
        wavs = check_wavs("slotpool", answers)
        log(f"speak (slotpool): 4 x POST /speak: statuses {[a[0] for a in answers]} in "
            f"{wall:.2f} s; {type(pool).__name__} {json.dumps(pool.stats)}")
        if pool.stats["requests_served"] != 4:
            raise AssertionError(f"speak (slotpool): the pool served {pool.stats}")
    finally:
        model_mod.sample_code0, cp_mod.sample_token, pool_mod.sample_code0 = saved
        tts.sampling = default_sampling

    def pool_record(text, f):
        """The pool's sampler record of frame ``f`` of ``text``, and its row."""
        if f == 0:
            return next(r for r in log_.frames if r["kind"] == "first" and r["text"] == text), 0
        return next((r, s) for r in log_.frames if r["kind"] == "tick"
                    for s, owner in r["owners"].items()
                    if owner == text and r["live"][s] and r["steps"][s] == f)

    def logits_of(rec, row, g):
        return rec["code0"][row] if g == 0 else rec["cp"][g - 1][row]

    def worst_gap(text, upto):
        """The largest relative L2 between the pool's and the solo path's
        logits over the (frame, group) pairs before ``upto``, inclusive."""
        worst = 0.0
        for f in range(upto[0] + 1):
            (prec, row), srec = pool_record(text, f), solo_logs[text][f]
            for g in range(16 if f < upto[0] else upto[1] + 1):
                ls, lp = logits_of(srec, 0, g), logits_of(prec, row, g)
                worst = max(worst, (torch.linalg.vector_norm(lp - ls)
                                    / torch.linalg.vector_norm(ls)).item())
        return worst

    for text, wav in zip(SPEAK_TEXTS, wavs):
        want_codes, want_wav = solo[text]
        got = pool_codes[text]
        part = first_parting(want_codes, got)
        worst = worst_gap(text, part or (len(got) - 1, 15))
        if part is None:
            err = np.abs(wav - read_wav(wav_bytes(want_wav, 24000))[0]).max()
            rel = err / max(np.abs(want_wav).max(), 1e-30)
            log(f"speak: {text!r}: pooled codes equal the solo path's ({len(got)} frames); "
                f"logits rel L2 at most {worst:.3e} (tol {SPEAK_TOL:g}); waveform max diff "
                f"{err:.3e} ({rel:.3e} of max |solo|, tol {SPEAK_WAV_TOL:g})")
            if not (rel <= SPEAK_WAV_TOL and worst <= SPEAK_TOL):
                raise AssertionError(f"speak: {text!r}: pooled waveform {rel} from the solo one, "
                                     f"logits rel L2 {worst}")
            continue
        f, g = part
        (pool_rec, row), solo_rec = pool_record(text, f), solo_logs[text][f]
        ls, lp = logits_of(solo_rec, 0, g), logits_of(pool_rec, row, g)
        a = int(want_codes[f][g]) if f < len(want_codes) else 2150
        b = int(got[f][g]) if f < len(got) else 2150
        margin = (ls[a] - ls[b]).item()
        gap = (ls - lp).abs().max().item()
        log(f"speak: {text!r}: pooled codes part from the solo path's at frame {f}, group {g}: "
            f"solo {a}, pool {b}; solo margin {margin:.6g}, largest logit gap {gap:.6g} "
            f"(near-tie if margin <= 2 x gap); logits rel L2 up to there at most {worst:.3e} "
            f"(tol {SPEAK_TOL:g})")
        if not (margin <= 2 * gap and worst <= SPEAK_TOL):
            raise AssertionError(f"speak: {text!r} parts at frame {f} group {g} with margin "
                                 f"{margin} (2 x gap {2 * gap}), logits rel L2 {worst}")

    (status, _, body), = serve(SpeechServer(build_registry(asr, tts=tts), port=0),
                               [{"text": ""}])[0]
    (status503, _, body503), = serve(SpeechServer(build_registry(asr), port=0),
                                     [{"text": "hello"}])[0]
    log(f"speak: no text -> {status} {body.decode()}; no tts registered -> {status503} "
        f"{body503.decode()}")
    if status != 400 or status503 != 503:
        raise AssertionError(f"speak: no text {status}, no tts {status503}")


# --------------------------------------------------------------------------- #
# the other TTS engines on /speak's ``engine``: CosyVoice3 and VibeVoice at the
# published 0.5B widths (random, seed 0), fp32 as the JAX package's default

COSY_TOKENS = 150        # the LLM's speech-token cap (about 6 s of audio; depth cut)
COSY_TEXT = "Hello from one card."    # 20 byte-level text tokens
COSY_SPLIT_TOKENS = 8    # tokens under the profiler
COSY_TOL = 1e-4          # each step's logits and the mel, relative L2, card vs host CPU (fp32)
COSY_WAV_TOL = 1e-3      # the waveform, relative L2, card vs host CPU
VIBE_FRAMES = 24         # the frame cap (3.2 s at 7.5 Hz; depth cut)
VIBE_TEXT = "Hello from one card, spoken by the port."
VIBE_SPLIT_FRAMES = 4    # frames under the profiler
VIBE_TOL = 1e-4          # each frame's latent on one history, relative L2, card vs host CPU (fp32)
VIBE_PREC_RATIO = 2.0    # those latents' distance from float64: the card's within 2 x the host's
VIBE_DRIFT_RATIO = 4.0   # the free-running latents' distance from float64: card within 4 x host
VIBE_WAV_TOL = 1e-3      # the waveform, relative L2, card vs host CPU
VIBE_VOICE_S = 3.0       # seconds of reference audio for encode_voice
#: the EOS head's bias in the random VibeVoice models: its sigmoid stays
#: far below 0.5, so every synthesis runs its whole frame cap
VIBE_EOS_BIAS = -30.0
SPEAK_ENGINE_TEXTS = {"cosyvoice": "hi", "vibevoice": "Hello there."}


def rel_l2(got, ref) -> float:
    import torch

    got, ref = torch.as_tensor(got).double().cpu(), torch.as_tensor(ref).double().cpu()
    return (torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)).item()


def check_counters_still(label, counters, before):
    """K1's and K3's counts must not move on a path with no packed product
    or int8 cache."""
    after = [c.value for c in counters]
    log(f"{label}: launch counters {', '.join(f'{c.name} {c.value}' for c in counters)} "
        f"(before the phase {', '.join(str(b) for b in before)})")
    if after != before:
        raise AssertionError(f"{label}: K1/K3 launched on a path without them: {before} -> "
                             f"{after}")


def timed(log_to, name, fn):
    """``fn`` with its wall time (synchronised) added to ``log_to[name]``."""
    import torch

    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        log_to[name] = log_to.get(name, 0.0) + time.perf_counter() - t0
        return out
    return run


def cosy_logits_run(model, text, gumbel):
    """The LLM loop of ``model`` on ``text`` with the draws ``gumbel``:
    (tokens, n, the logits each step's sampler saw)."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.cosyvoice import model as cosy_mod

    seen = []
    sample = cosy_mod._sample_token

    def record(lg, *a, **kw):
        seen.append(lg.float().cpu())
        return sample(lg, *a, **kw)

    ids = model._encode_text(text)
    bucket = max(16, ((len(ids) + 15) // 16) * 16)
    arr = np.zeros(bucket, np.int32)
    arr[:len(ids)] = ids
    with patch.multiple(cosy_mod, _sample_token=record), torch.inference_mode():
        out, n, _ = cosy_mod.llm_generate_tokens(model.params, model.cfg, arr, len(ids),
                                                 gumbel.to(model.device), model.cfg.max_tokens)
    return out.cpu().numpy(), int(n), seen


def token_parting(label, card, host, card_logits, host_logits, gumbel=None, tol=None):
    """Check two token lists equal, or parting at a near-tie (ROADMAP §3
    entry 9's rule, both halves): every step's logits up to and including
    the first parting (all of them where none) within ``tol`` (default
    ``COSY_TOL``) relative L2 of the host's, which bounds the gap there too;
    and at the parting the host's score margin between its token and the
    card's (its logits plus the step's Gumbel draws where sampled, greedy
    where ``gumbel`` is None) within twice the largest card-vs-host logit
    gap."""
    tol = COSY_TOL if tol is None else tol
    n = min(len(card), len(host))
    part = next((i for i in range(n) if card[i] != host[i]), None)
    last = n - 1 if part is None else part
    rels = [rel_l2(card_logits[i], host_logits[i]) for i in range(last + 1)]
    worst = max(rels)
    log(f"{label}: the logits of steps 0..{last} card vs host, rel L2 at most {worst:.3e} "
        f"(step {rels.index(worst)}; first {rels[0]:.3e}; tol {tol:g})")
    if not worst <= tol:
        raise AssertionError(f"{label}: logits rel L2 {worst} > {tol} at step "
                             f"{rels.index(worst)}")
    if part is None:
        log(f"{label}: tokens equal card vs host ({n} tokens)")
        return
    lh, lc = host_logits[part], card_logits[part]
    g = 0.0 if gumbel is None else gumbel[part, 0].cpu()
    a, b = int(host[part]), int(card[part])
    margin = ((lh + g)[a] - (lh + g)[b]).item()
    gap = (lh - lc).abs().max().item()
    log(f"{label}: tokens part at step {part}: host {a}, card {b}; host score margin "
        f"{margin:.6g}, largest logit gap {gap:.6g} (near-tie if margin <= 2 x gap)")
    if not margin <= 2 * gap:
        raise AssertionError(f"{label}: tokens part at step {part} with margin {margin} > 2 x "
                             f"{gap}")


def phase_cosyvoice(dev, counters, dev_name, power):
    """CosyVoice3 ``CONFIG_05B`` (LLM 24 x 896, DiT 22 x 1024, HiFT 512),
    fp32, random weights (seed 0), ``COSY_TOKENS`` speech tokens at most:
    (a) cut to 2 LLM and 2 DiT layers, card vs host CPU with the same
    draws: every step's logits up to the first parting and the mel within
    ``COSY_TOL``, the tokens equal or parting at a near-tie, the waveform
    within
    ``COSY_WAV_TOL`` (relative L2); (b) the full model drawn on the card:
    tokens/s of the LLM loop, device ms a token by profiler range, ms of the
    flow and of HiFT a second of audio, RTF, peak memory; one
    ``synthesize_stream`` and one bf16 ``synthesize``, each finite audio of
    960 samples a token. K1 and K3 must not run. Returns the fp32 model."""
    import dataclasses

    import torch

    from qwen3_asr_swift_tpu_torch.models.cosyvoice import CONFIG_05B, CosyVoiceTTS
    from qwen3_asr_swift_tpu_torch.models.cosyvoice import model as cosy_mod
    from qwen3_asr_swift_tpu_torch.models.cosyvoice.dit import flow_generate
    from qwen3_asr_swift_tpu_torch.models.cosyvoice.hift import hift_generate, source_noise

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(CONFIG_05B, max_tokens=COSY_TOKENS)
    spt = cfg.flow.token_mel_ratio * cfg.hift.samples_per_frame        # samples a token

    # (a) card vs host at 2 + 2 layers, the same numpy weights and draws
    cut = dataclasses.replace(cfg, num_layers=2, flow=dataclasses.replace(
        cfg.flow, dit=dataclasses.replace(cfg.flow.dit, depth=2)))
    t0 = time.perf_counter()
    tree = cosy_mod.init_cosyvoice_params(np.random.default_rng(0), cut)
    host = CosyVoiceTTS(cut, tree, device="cpu")
    card = CosyVoiceTTS(cut, tree, device=dev)
    del tree
    gumbel = cosy_mod.gumbel_draws(cut, cut.max_tokens, torch.Generator().manual_seed(0))
    h_tok, h_n, h_logits = cosy_logits_run(host, COSY_TEXT, gumbel)
    c_tok, c_n, c_logits = cosy_logits_run(card, COSY_TEXT, gumbel)
    log(f"cosyvoice (2 + 2 layers, fp32): {c_n} tokens on the card, {h_n} on the host")
    token_parting("cosyvoice", c_tok[:c_n], h_tok[:h_n], c_logits, h_logits, gumbel)
    tokens = c_tok[:c_n]
    bucket = max(8, ((len(tokens) + 7) // 8) * 8)
    padded = np.concatenate([tokens, np.full(bucket - len(tokens), tokens[-1])])
    noise = torch.randn((1, bucket * 2, cut.flow.output_size), generator=torch.Generator()
                        .manual_seed(1))
    src = source_noise(cut.hift, 1, bucket * 2 * cut.hift.samples_per_frame,
                       torch.Generator().manual_seed(2))
    out = {}
    for where, m in (("host", host), ("card", card)):
        with torch.inference_mode():
            mel = flow_generate(m.params["flow"], cut.flow,
                                torch.as_tensor(padded, device=m.device)[None], noise.to(m.device))
            wav = hift_generate(m.params["hift"], cut.hift, mel,
                                tuple(t.to(m.device) for t in src))
        out[where] = (mel.cpu(), wav.cpu())
    rel_mel = rel_l2(out["card"][0], out["host"][0])
    rel_wav = rel_l2(out["card"][1], out["host"][1])
    log(f"cosyvoice (2 + 2 layers): mel rel L2 {rel_mel:.3e} (tol {COSY_TOL:g}), waveform rel "
        f"L2 {rel_wav:.3e} (tol {COSY_WAV_TOL:g}) over {out['host'][1].shape[1]} samples; "
        f"{time.perf_counter() - t0:.1f} s with the host's share")
    if not (rel_mel <= COSY_TOL and rel_wav <= COSY_WAV_TOL):
        raise AssertionError(f"cosyvoice card vs host: mel {rel_mel}, waveform {rel_wav}")
    del host, card, out

    # (b) the full model, drawn on the card
    t0 = time.perf_counter()
    model = CosyVoiceTTS.init_random_on_device(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log(f"cosyvoice weights: CONFIG_05B drawn on the card in {time.perf_counter() - t0:.1f} s")
    model.synthesize("warm up")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    stages = {}
    with patch.multiple(cosy_mod, flow_generate=timed(stages, "flow", cosy_mod.flow_generate),
                        hift_generate=timed(stages, "hift", cosy_mod.hift_generate),
                        llm_generate_tokens=timed(stages, "llm", cosy_mod.llm_generate_tokens)):
        t0 = time.perf_counter()
        chunk = model.synthesize(COSY_TEXT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = model.last_loop["steps_run"]
    audio_s = len(chunk.samples) / chunk.sample_rate
    n_tok = len(chunk.samples) // spt
    log(f"cosyvoice (CONFIG_05B, fp32): {n_tok} tokens ({steps} run, "
        f"{model.last_loop['done_reads']} host reads of done), {audio_s:.2f} s of audio in "
        f"{wall:.3f} s: RTF {wall / audio_s:.3f}; LLM loop {stages['llm']:.3f} s = "
        f"{steps / stages['llm']:.1f} tokens/s; flow {1e3 * stages['flow'] / audio_s:.1f} ms and "
        f"HiFT {1e3 * stages['hift'] / audio_s:.1f} ms a second of audio; peak memory "
        f"{peak:.2f} GiB ({resident:.2f} resident before it, this model's weights and the "
        f"earlier phases' models); on {dev_name} ({power})")
    if (len(chunk.samples) == 0 or len(chunk.samples) % spt
            or not np.isfinite(chunk.samples).all()):
        raise AssertionError(f"cosyvoice: {len(chunk.samples)} samples, finite "
                             f"{np.isfinite(chunk.samples).all()}")

    # device ms a token by range: a short loop under the profiler
    def is_prefill(lp, x, *a, **kw):
        return "cosy.prefill" if x.shape[1] > 1 else "cosy.step"

    ids = model._encode_text(COSY_TEXT)
    arr = np.zeros(max(16, ((len(ids) + 15) // 16) * 16), np.int32)
    arr[:len(ids)] = ids
    g = model._gumbel(0)[:COSY_SPLIT_TOKENS]
    with patch.multiple(cosy_mod,
                        qwen2_decoder_layer=ranged("", cosy_mod.qwen2_decoder_layer, is_prefill),
                        _sample_token=ranged("cosy.sample", cosy_mod._sample_token)):
        def run():
            with torch.inference_mode():
                cosy_mod.llm_generate_tokens(model.params, cfg, arr, len(ids), g,
                                             COSY_SPLIT_TOKENS)
        ranges, _, kernels, prof_wall = range_device_ms(run, "cosy.")
    busy = sum(kernels.values()) / 1e3
    n = COSY_SPLIT_TOKENS
    log(f"cosyvoice LLM under the profiler ({n} tokens): wall {prof_wall:.3f} s, device busy "
        f"{busy:.2f} ms (idle {100 * (1 - busy / 1e3 / prof_wall):.1f} %); prefill "
        f"{ranges.get('prefill', 0.0):.3f} ms once; device ms a token: layers "
        f"{ranges.get('step', 0.0) / (n - 1):.3f}, sampler {ranges.get('sample', 0.0) / n:.3f}, "
        f"other (embeddings, head, masks) {ranges.get('other', 0.0) / n:.3f}; on {dev_name} "
        f"({power})")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]:
        log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")

    chunks = list(model.synthesize_stream(COSY_TEXT))
    streamed = np.concatenate([c.samples for c in chunks])
    bf16 = CosyVoiceTTS.init_random_on_device(cfg, 0, device=dev, dtype=torch.bfloat16)
    half = bf16.synthesize(COSY_TEXT).samples
    del bf16
    n_half = len(half) // spt
    log(f"cosyvoice synthesize_stream: {len(chunks)} chunks, {len(streamed)} samples "
        f"({len(streamed) // spt} tokens); bf16 synthesize: {len(half)} samples "
        f"({n_half} tokens); both finite: {np.isfinite(streamed).all()} "
        f"{np.isfinite(half).all()}")
    if not (len(streamed) == n_tok * spt and np.isfinite(streamed).all()
            and n_half and len(half) == n_half * spt and np.isfinite(half).all()):
        raise AssertionError(f"cosyvoice stream {len(streamed)} samples for {n_tok} tokens, "
                             f"bf16 {len(half)} samples")
    check_counters_still("cosyvoice", counters, before)
    log(f"cosyvoice: phase {time.perf_counter() - t_phase:.1f} s")
    return model


def phase_vibevoice(dev, counters, dev_name, power):
    """VibeVoice ``CONFIG_05B`` (base LM 4 x 896 + TTS LM 20 x 896,
    diffusion head 4 layers, 20 DPM steps with CFG, σ-VAE decoder ×3200),
    fp32, random weights (seed 0) with the EOS head biased off
    (``VIBE_EOS_BIAS``), ``VIBE_FRAMES`` frames: (a) cut to 2 + 2 layers,
    card vs host CPU with the same draws, and a float64 run on the card:
    on the float64 run's history, each frame's latent of the card within
    ``VIBE_TOL`` of the host's and their distance from float64 within
    ``VIBE_PREC_RATIO`` times the host's; free running (the loop feeds
    each latent back, and with random weights amplifies rounding frame by
    frame), the card's latents no farther from float64 than
    ``VIBE_DRIFT_RATIO`` times the host's; every frame's EOS decision and
    the frame count equal, the card's latents decoded on both within
    ``VIBE_WAV_TOL`` (relative L2); (b) the full model drawn on the
    card: frames/s against 7.5 Hz, device ms a frame split into LM,
    diffusion and decode by profiler range, RTF, peak memory; then
    ``encode_voice`` on ``VIBE_VOICE_S`` s of audio and a ``synthesize``
    with that voice. K1 and K3 must not run. Returns the model."""
    import dataclasses
    import tempfile

    import torch

    from qwen3_asr_swift_tpu_torch.models.vibevoice import CONFIG_05B, VibeVoiceTTS
    from qwen3_asr_swift_tpu_torch.models.vibevoice import model as vibe_mod

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(CONFIG_05B, max_frames=VIBE_FRAMES)
    spf = cfg.vae_upsample

    # (a) card vs host at 2 + 2 layers, the same numpy weights and starts
    cut = dataclasses.replace(cfg, num_layers=4, tts_backbone_layers=2)
    t0 = time.perf_counter()
    tree = vibe_mod.init_vibevoice_params(np.random.default_rng(0), cut)
    tree["eos_classifier"]["fc2"]["bias"][:] = VIBE_EOS_BIAS
    starts = vibe_mod.frame_starts(cut, VIBE_FRAMES, torch.Generator().manual_seed(0))

    def run(m, forced=None):
        """(latents, frames, EOS probabilities, each frame's own solve);
        with ``forced`` [frames, latent] each frame's solve is recorded but
        ``forced``'s latent goes on, so the loop follows that history."""
        # the draws' device bound as a default: a closure over ``m`` would be
        # a cycle that keeps a deleted model on the card until gc runs
        m._starts = lambda seed, max_frames, to=m.device: starts[:max_frames].to(to)
        probs, own = [], []
        eos, solve = vibe_mod.eos_probability, vibe_mod.dpm_solve

        def solve_(*a, **kw):
            own.append(solve(*a, **kw))
            if forced is None:
                return own[-1]
            return torch.as_tensor(forced[len(own) - 1:len(own)]).to(own[-1])

        with patch.multiple(vibe_mod, dpm_solve=solve_,
                            eos_probability=lambda p, h: probs.append(eos(p, h)) or probs[-1]):
            lat, n = m._run(VIBE_TEXT, np.zeros((0, cut.latent_dim), np.float32), VIBE_FRAMES, 0)
        return (lat[:n], n, torch.cat([q.double().cpu().reshape(-1) for q in probs]),
                torch.cat([o.double().cpu() for o in own]))

    card = VibeVoiceTTS(cut, tree, device=dev)
    host = VibeVoiceTTS(cut, tree, device="cpu")
    # float64 on the card: it agrees with the host's float64 run to 2e-12
    # (ROADMAP §3 entry 3) and spares the host a third run
    exact = VibeVoiceTTS(cut, tree, device=dev, dtype=torch.float64)
    del tree
    cl, cn, cp, _ = run(card)                       # free running
    hl, hn, hp, _ = run(host)
    el, en, ep, _ = run(exact)
    _, _, cfp, c_own = run(card, forced=el)         # each frame on the float64 history
    _, _, hfp, h_own = run(host, forced=el)
    per_frame = [rel_l2(c_own[i], h_own[i]) for i in range(en)]
    card_prec, host_prec = rel_l2(c_own, el), rel_l2(h_own, el)
    card_drift, host_drift = rel_l2(cl, el), rel_l2(hl, el)
    ce, he = (cfp > 0.5).tolist(), (hfp > 0.5).tolist()
    # with the EOS bias at -30 the probabilities are e^(logit): their
    # relative gap is the EOS logits' absolute gap
    p_gap = ((cfp - hfp).abs() / hfp).max().item()
    with torch.inference_mode():
        cw = card._latents_to_audio(cl)
        hw = host._latents_to_audio(cl)
    rel_wav = rel_l2(cw, hw)
    del card, host, exact
    log(f"vibevoice (2 + 2 layers, fp32): {cn} frames on the card, {hn} on the host, {en} in "
        f"float64; each frame on the float64 run's history, card vs host: rel L2 at most "
        f"{max(per_frame):.3e} (tol {VIBE_TOL:g}; first {per_frame[0]:.3e}), and from float64 "
        f"card {card_prec:.3e}, host {host_prec:.3e} (card tol {VIBE_PREC_RATIO:g} x host); "
        f"EOS decisions equal {ce == he} over {len(ce)} frames (probabilities' largest "
        f"relative gap {p_gap:.3e}); the card's latents decoded on both, rel L2 {rel_wav:.3e} "
        f"(tol {VIBE_WAV_TOL:g}); {time.perf_counter() - t0:.1f} s with the host's share")
    log(f"vibevoice free running: latents from float64 card {card_drift:.3e}, host "
        f"{host_drift:.3e} (card tol {VIBE_DRIFT_RATIO:g} x host); card vs host up to frames "
        f"1, {cn // 2 + 1}, {cn}: "
        + ", ".join(f"{rel_l2(cl[:i + 1], hl[:i + 1]):.3e}" for i in (0, cn // 2, cn - 1)))
    if not (cn == hn == en and ce == he and max(per_frame) <= VIBE_TOL
            and card_prec <= VIBE_PREC_RATIO * host_prec
            and card_drift <= VIBE_DRIFT_RATIO * host_drift and rel_wav <= VIBE_WAV_TOL):
        raise AssertionError(f"vibevoice card vs host: frames {cn}/{hn}/{en}, EOS equal "
                             f"{ce == he}, latents {max(per_frame)}, from float64 {card_prec} "
                             f"vs {host_prec}, free run {card_drift} vs {host_drift}, "
                             f"waveform {rel_wav}")

    # (b) the full model, drawn on the card
    t0 = time.perf_counter()
    model = VibeVoiceTTS.init_random_on_device(cfg, 0, device=dev)
    model.params["eos_classifier"]["fc2"]["bias"].fill_(VIBE_EOS_BIAS)
    torch.cuda.synchronize()
    log(f"vibevoice weights: CONFIG_05B drawn on the card in {time.perf_counter() - t0:.1f} s")
    model.synthesize("warm up", max_frames=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    stages = {}
    with patch.multiple(vibe_mod,
                        generate_frames=timed(stages, "frames", vibe_mod.generate_frames),
                        decode_chunked=timed(stages, "decode", vibe_mod.decode_chunked)):
        t0 = time.perf_counter()
        chunk = model.synthesize(VIBE_TEXT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(chunk.samples) // spf
    audio_s = len(chunk.samples) / chunk.sample_rate
    log(f"vibevoice (CONFIG_05B, fp32): {n} frames ({model.last_loop['frames_run']} run, "
        f"{model.last_loop['eos_reads']} host reads of the EOS flag), {audio_s:.2f} s of audio "
        f"in {wall:.3f} s: RTF {wall / audio_s:.3f}; frame loop {stages['frames']:.3f} s = "
        f"{n / stages['frames']:.2f} frames/s (real time 7.5); decode "
        f"{1e3 * stages['decode'] / audio_s:.1f} ms a second of audio; peak memory {peak:.2f} "
        f"GiB ({resident:.2f} resident before it); on {dev_name} ({power})")
    if not (n == VIBE_FRAMES and len(chunk.samples) == n * spf
            and np.isfinite(chunk.samples).all()):
        raise AssertionError(f"vibevoice: {len(chunk.samples)} samples, finite "
                             f"{np.isfinite(chunk.samples).all()}")

    def lm_range(lp, x, *a, **kw):
        return "vibe.prefill" if x.shape[1] > 1 else "vibe.lm"

    with patch.multiple(vibe_mod, _layer_forward=ranged("", vibe_mod._layer_forward, lm_range),
                        dpm_solve=ranged("vibe.diffusion", vibe_mod.dpm_solve),
                        decode_chunked=ranged("vibe.decode", vibe_mod.decode_chunked)):
        ranges, _, kernels, prof_wall = range_device_ms(
            lambda: model.synthesize(VIBE_TEXT, max_frames=VIBE_SPLIT_FRAMES), "vibe.")
    busy = sum(kernels.values()) / 1e3
    f = VIBE_SPLIT_FRAMES
    log(f"vibevoice under the profiler ({f} frames): wall {prof_wall:.3f} s, device busy "
        f"{busy:.2f} ms (idle {100 * (1 - busy / 1e3 / prof_wall):.1f} %); prefill "
        f"{ranges.get('prefill', 0.0):.3f} ms once; device ms a frame: LM (both streams) "
        f"{ranges.get('lm', 0.0) / f:.3f}, diffusion {ranges.get('diffusion', 0.0) / f:.3f}, "
        f"decode {ranges.get('decode', 0.0) / f:.3f}, other "
        f"{ranges.get('other', 0.0) / f:.3f}; on {dev_name} ({power})")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]:
        log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")

    t = np.arange(int(VIBE_VOICE_S * cfg.sample_rate)) / cfg.sample_rate
    ref_audio = (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = model.encode_voice(ref_audio, "a reference voice", os.path.join(d, "voice.npz"))
        enc_s = time.perf_counter() - t0
        lat = np.load(path)["latents"]
        voiced = model.synthesize(VIBE_TEXT, voice=str(path)).samples
    log(f"vibevoice encode_voice: {VIBE_VOICE_S:g} s -> {lat.shape[0]} latents in {enc_s:.3f} s; "
        f"synthesize with that voice: {len(voiced) // spf} frames, finite "
        f"{np.isfinite(voiced).all()}")
    if not (lat.shape == (min(64, int(VIBE_VOICE_S * cfg.sample_rate) // spf), cfg.latent_dim)
            and np.isfinite(lat).all() and len(voiced) == VIBE_FRAMES * spf
            and np.isfinite(voiced).all()):
        raise AssertionError(f"vibevoice voice: latents {lat.shape}, {len(voiced)} samples")
    check_counters_still("vibevoice", counters, before)
    log(f"vibevoice: phase {time.perf_counter() - t_phase:.1f} s")
    return model


KOKORO_CHECK_TEXT = "Hello there."     # card vs host: 14 ids, bucket 16, 384 frames
# the timed run: 55 ids with the bracketing pads, bucket 64, 1,536 frames
KOKORO_TEXT = "The weather on the coast is fine today, so we walk."
KOKORO_TOL = 1e-4        # F0/N and the decoder's input, relative L2, card vs host CPU (fp32)
KOKORO_TIE = 1e-3        # a duration may part only where the host's lies this near x.5
KOKORO_PREC_RATIO = 2.0  # the waveform's distance from a float64 run: card within 2 x host
VOX_TOKENS = 32          # patches a synthesis (5.12 s at 6.25 Hz; depth cut in output)
VOX_CHECK_PATCHES = 16   # patches of the card-vs-host loop with the stop head off
VOX_TEXT = "Hello from one card, spoken by the port."
VOX_SPLIT_PATCHES = 4    # patches under the profiler
VOX_TOL = 1e-4           # each step's patch, of max |host|, card vs host CPU (fp32)
VOX_TIE = 1e-3           # an FSQ level may part only where the host's tanh(.)*9 lies this near x.5
VOX_WAV_TOL = 1e-3       # the VAE decode, relative L2, card vs host CPU
VOX_PREC_RATIO = 2.0     # the VAE decode's distance from float64: card within 2 x host
VOX_VOICE_S = 3.0        # seconds of 48 kHz reference audio for a cloned synthesis
VOX_STOP_BIAS = 30.0     # the stop head's class-0 bias (stop off), as vibevoice's EOS bias
SPEAK_VOX_TOKENS = 8     # VoxCPM2's patch cap on /speak (1.28 s; depth cut in output)
SPEAK_ENGINE_TEXTS.update({"kokoro": "Hello there.", "voxcpm2": "Hello."})


def kokoro_snapped_source(kokoro_mod):
    """``_harmonic_source`` with the edge frames' phase bins set to their
    exact values (0, or π where the real part is negative): those frames are
    symmetric, so each imaginary part is a rounding residual and the sign
    that atan2 turns into ±π follows the sum order (ROADMAP §3)."""
    import torch

    source = kokoro_mod._harmonic_source

    def run(p, cfg, f0, noise):
        s = source(p, cfg, f0, noise).clone()
        nb = cfg.gen_istft_n_fft // 2 + 1
        edge = s[:, [0, -1], nb:]
        s[:, [0, -1], nb:] = torch.where(edge.abs() > np.pi / 2, np.pi, 0.0).to(s.dtype)
        return s
    return run


def phase_kokoro(dev, counters, dev_name, power):
    """Kokoro ``CONFIG_82M`` (ALBERT 768 x 12 shared, hidden 512, decoder
    1024, iSTFTNet 10 x 6 upsampling, hop 5), fp32, random weights drawn on
    the card (torch seed 0): (a) card vs host CPU on ``KOKORO_CHECK_TEXT``,
    stage by stage, each stage on the host's inputs, with the same source
    noise: the durations equal, or parting only where the host's pre-round
    duration lies within ``KOKORO_TIE`` of a half-integer; F0/N and the
    decoder's input within ``KOKORO_TOL``; the waveform of card, host and a
    float64 run on the card, each from the host's decoder input: the card
    no farther from float64 than ``KOKORO_PREC_RATIO`` times the host (the
    fp32 phase cumsum over the buffer parts late in it); (b) a timed
    ``synthesize`` of ``KOKORO_TEXT``: RTF, device ms by profiler range,
    the frame budget against the spoken frames, idle share, peak memory
    and the largest blocks live at it (:func:`peak_tensors`). K1 and K3
    must not run. Returns the model."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.kokoro import CONFIG_82M, KokoroTTS
    from qwen3_asr_swift_tpu_torch.models.kokoro import model as kokoro_mod

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    cfg = CONFIG_82M
    spf = cfg.samples_per_frame
    t0 = time.perf_counter()
    model = KokoroTTS.init_random_on_device(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log(f"kokoro weights: CONFIG_82M drawn on the card in {time.perf_counter() - t0:.1f} s")

    # (a) card vs host, stage by stage on the host's inputs
    t0 = time.perf_counter()
    host = KokoroTTS(cfg, tree_to(model.params, "cpu"), device="cpu")
    exact = KokoroTTS(cfg, model.params, device=dev, dtype=torch.float64)
    ids, n, ref_s, max_frames = host.prepare(KOKORO_CHECK_TEXT)
    noise = kokoro_mod.source_noise(cfg, 1, 2 * max_frames, torch.Generator().manual_seed(0))
    speed = torch.tensor(1.0)
    got = {}
    with torch.inference_mode():
        for where, m in (("host", host), ("card", model)):
            got[where] = kokoro_mod.predict_alignment(
                m.params, cfg, torch.as_tensor(ids, device=m.device), n,
                torch.as_tensor(ref_s, device=m.device), speed.to(m.device), max_frames)
        en, fmask, tok_idx, total, h_dur, h_raw, valid = got["host"]
        c_dur = got["card"][4].cpu()
        parted = (c_dur != h_dur).nonzero()[:, 1].tolist()
        gap = [abs(h_raw[0, i].item() % 1.0 - 0.5) for i in parted]
        s_pros = torch.as_tensor(ref_s[:, cfg.style_dim:])
        s_dec = torch.as_tensor(ref_s[:, :cfg.style_dim])
        t_en = kokoro_mod.text_encode(host.params["text_encoder"], cfg, torch.as_tensor(ids), n,
                                      valid)
        asr = torch.where(fmask, t_en[:, tok_idx], 0.0)
        stage = {}
        for where, m in (("host", host), ("card", model)):
            to = m.device
            f0, nn_ = kokoro_mod.prosody_f0n(m.params["predictor"], cfg, en.to(to),
                                             s_pros.to(to), total.to(to))
            stage[where] = (f0.cpu(), nn_.cpu())
        f0, nn_ = stage["host"]
        for where, m in (("host", host), ("card", model)):
            to = m.device
            x, nv = kokoro_mod.decoder_input(m.params["decoder"], cfg, asr.to(to), f0.to(to),
                                             nn_.to(to), s_dec.to(to), total.to(to))
            stage[where] += (x.cpu(),)
        x = stage["host"][2]
        wav, inner = {}, {}
        snapped, spectrum = kokoro_snapped_source(kokoro_mod), kokoro_mod._generator_spectrum
        for where, m in (("host", host), ("card", model), ("exact", exact)):
            to, dt = m.device, m.dtype
            seen = inner[where] = []
            with patch.multiple(kokoro_mod,
                                _harmonic_source=lambda *a: seen.append(snapped(*a)) or seen[-1],
                                _generator_spectrum=lambda *a, **k: seen.append(
                                    spectrum(*a, **k)) or seen[-1]):
                wav[where] = kokoro_mod.generator(
                    m.params["decoder"]["generator"], cfg, x.to(to, dt), s_dec.to(to, dt),
                    f0.to(to, dt), noise.to(to), n_valid=nv.to(to)).double().cpu()
    # where the runs part from float64: the source's STFT (as complex values),
    # then the generator's spectrum
    nb = cfg.gen_istft_n_fft // 2 + 1

    def complex_of(src):
        src = src.double().cpu()
        return src[..., :nb] * torch.exp(1j * src[..., nb:])

    inner_prec = {w: (rel_l2(complex_of(inner[w][0]).abs(), complex_of(inner["exact"][0]).abs()),
                      rel_l2(torch.view_as_real(complex_of(inner[w][0])),
                             torch.view_as_real(complex_of(inner["exact"][0]))),
                      rel_l2(inner[w][1][0], inner["exact"][1][0]),
                      rel_l2(inner[w][1][1], inner["exact"][1][1]))
                  for w in ("card", "host")}
    log("kokoro (a) from float64, card / host: source magnitude "
        + " / ".join(f"{inner_prec[w][0]:.3e}" for w in ("card", "host")) + ", source STFT "
        + " / ".join(f"{inner_prec[w][1]:.3e}" for w in ("card", "host"))
        + ", generator magnitude bins " + " / ".join(f"{inner_prec[w][2]:.3e}" for w in ("card", "host"))
        + ", phase bins " + " / ".join(f"{inner_prec[w][3]:.3e}" for w in ("card", "host")))
    del inner
    rel_f0, rel_n = rel_l2(stage["card"][0], f0), rel_l2(stage["card"][1], nn_)
    rel_x = rel_l2(stage["card"][2], x)
    card_prec, host_prec = rel_l2(wav["card"], wav["exact"]), rel_l2(wav["host"], wav["exact"])
    n_ids = int(valid.sum())
    log(f"kokoro (a) card vs host (fp32, {n_ids} ids, {max_frames} frames of budget): durations "
        f"{h_dur[0, :n_ids].tolist()} (total {int(total)}), {len(parted)} parting "
        f"(distance of the host's from x.5: {gap}, tol {KOKORO_TIE:g}); F0 rel L2 {rel_f0:.3e}, "
        f"N {rel_n:.3e}, decoder input {rel_x:.3e} (tol {KOKORO_TOL:g}); the waveform "
        f"({wav['host'].shape[1]} samples) from float64: card {card_prec:.3e}, host "
        f"{host_prec:.3e} (card tol {KOKORO_PREC_RATIO:g} x host); card vs host "
        f"{rel_l2(wav['card'], wav['host']):.3e}; {time.perf_counter() - t0:.1f} s with the "
        f"host's share")
    if not (all(g <= KOKORO_TIE for g in gap) and max(rel_f0, rel_n, rel_x) <= KOKORO_TOL
            and card_prec <= KOKORO_PREC_RATIO * host_prec
            and all(torch.isfinite(w).all() for w in wav.values())):
        raise AssertionError(f"kokoro card vs host: durations parting at {parted} ({gap}), "
                             f"F0/N/x {rel_f0}/{rel_n}/{rel_x}, from float64 {card_prec} vs "
                             f"{host_prec}")
    del host, exact, got, stage, wav

    # (b) the timed synthesis on the card
    model.synthesize("warm up")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    chunk = model.synthesize(KOKORO_TEXT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    budget = dict(model.last_budget)
    audio_s = len(chunk.samples) / chunk.sample_rate
    ranges_of = {"predict_alignment": "predictor", "prosody_f0n": "predictor",
                 "text_encode": "text", "decoder_input": "decoder",
                 "_harmonic_source": "source", "_source_branch": "source",
                 "_generator_spectrum": "generator",
                 "_gen_istft": "istft"}
    with patch.multiple(kokoro_mod, **{f: ranged(f"kokoro.{r}", getattr(kokoro_mod, f))
                                       for f, r in ranges_of.items()}):
        ranges, _, kernels, prof_wall = range_device_ms(lambda: model.synthesize(KOKORO_TEXT),
                                                        "kokoro.")
    busy = sum(kernels.values()) / 1e3
    log(f"kokoro (b) CONFIG_82M fp32, {len(model.prepare(KOKORO_TEXT)[0][0])}-id bucket: "
        f"{audio_s:.2f} s of audio in {wall:.3f} s: RTF {wall / audio_s:.3f}; frame budget "
        f"{budget['frames']} frames = {budget['frames'] * spf} samples, spoken "
        f"{budget['spoken_frames']} frames = {budget['spoken_frames'] * spf} samples "
        f"({budget['spoken_frames'] / budget['frames']:.3f} of the budget); peak memory "
        f"{peak:.2f} GiB ({resident:.2f} resident before it); on {dev_name} ({power})")
    log(f"kokoro under the profiler: wall {prof_wall:.3f} s, device busy {busy:.2f} ms (idle "
        f"{100 * (1 - busy / 1e3 / prof_wall):.1f} %); device ms: ALBERT + predictor "
        f"{ranges.get('predictor', 0.0):.3f}, text encoder {ranges.get('text', 0.0):.3f}, "
        f"decoder {ranges.get('decoder', 0.0):.3f}, source (2x the generator's length) "
        f"{ranges.get('source', 0.0):.3f}, generator {ranges.get('generator', 0.0):.3f}, iSTFT "
        f"{ranges.get('istft', 0.0):.3f}, other {ranges.get('other', 0.0):.3f}; on {dev_name} "
        f"({power})")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]:
        log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")
    held, blocks = peak_tensors(lambda: model.synthesize(KOKORO_TEXT))
    log(f"kokoro peak: {held / 2 ** 30:.2f} GiB allocated and not yet freed at the synthesis's "
        f"peak; its largest blocks:")
    for size, at in blocks:
        log(f"  {size / 2 ** 20:9.1f} MiB  {at}")
    if not (len(chunk.samples) == budget["spoken_frames"] * spf > 0
            and np.isfinite(chunk.samples).all()):
        raise AssertionError(f"kokoro: {len(chunk.samples)} samples, finite "
                             f"{np.isfinite(chunk.samples).all()}")
    check_counters_still("kokoro", counters, before)
    log(f"kokoro: phase {time.perf_counter() - t_phase:.1f} s")
    return model


def fsq_levels(log_to, fsq):
    """``fsq`` that also records each one-row call's tanh(.)·scale, as fsq
    computes it before rounding (the patch loop's calls; the prefill's are
    [1, T, H])."""
    import torch

    from qwen3_asr_swift_tpu_torch.ops.nn import linear, upcast

    def run(p, cfg, x):
        if x.dim() == 2:
            log_to.append((torch.tanh(upcast(linear(x, p["in_proj"]))) * cfg.fsq_scale).cpu())
        return fsq(p, cfg, x)
    return run


def phase_voxcpm2(dev, counters, dev_name, power):
    """VoxCPM2 ``CONFIG_2B`` (base LM 2048 x 28, residual 8, LocEnc and
    DiT 1024 x 12, vocab 73,448, the AudioVAE at 48 kHz), random weights
    drawn on the card (torch seed 0), the stop head biased off
    (``VOX_STOP_BIAS``), ``VOX_TOKENS`` patches: (a) cut to 2 base + 1
    residual + 1 LocEnc + 1 DiT layers at the published widths, fp32, card
    vs host CPU with the same start noise: each step's patch within
    ``VOX_TOL`` of max |host| up to the first FSQ level that parts, which
    must be a near-tie (the host's tanh(.)·9 within ``VOX_TIE`` of a
    half-integer); ``n_steps`` equal with the stop head live; the VAE
    decode within ``VOX_WAV_TOL``, and no farther from a float64 decode on
    the card than ``VOX_PREC_RATIO`` times the host; (b) the full model in bf16: patches/s
    against 6.25 Hz, device ms a patch by profiler range, prefill ms, VAE ms
    a second of audio, RTF, idle share, peak memory; one cloned synthesis
    (``VOX_VOICE_S`` s of 48 kHz audio) and one with ``instruct``. K1 and
    K3 must not run. Returns the bf16 model."""
    import dataclasses

    import torch

    from qwen3_asr_swift_tpu_torch.core.params import param_bytes
    from qwen3_asr_swift_tpu_torch.models.voxcpm2 import CONFIG_2B, VoxCPM2TTS
    from qwen3_asr_swift_tpu_torch.models.voxcpm2 import model as vox_mod
    from qwen3_asr_swift_tpu_torch.models.voxcpm2.vae import vae_decode

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(CONFIG_2B, max_tokens=VOX_TOKENS)
    per_patch = cfg.patch_size * cfg.vae.decode_chunk_size          # 48 kHz samples a patch

    # (a) card vs host at 2 + 1 + 1 + 1 layers, published widths, fp32
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, num_layers=2, res_layers=1, enc_layers=1, dit_layers=1)
    card = VoxCPM2TTS.init_random_on_device(cut, 0, device=dev, dtype=torch.float32)
    host = VoxCPM2TTS(cut, tree_to(card.params, "cpu"), device="cpu")
    arr, n, ref_pad, n_ref = host.prepare(VOX_TEXT)
    starts = vox_mod.start_noise(cut, VOX_CHECK_PATCHES, torch.Generator().manual_seed(0))
    runs = {}
    for bias in (VOX_STOP_BIAS, None):
        for where, m in (("host", host), ("card", card)):
            m.params["stop_head"].pop("bias", None)
            if bias is not None:
                m.params["stop_head"]["bias"] = torch.tensor([bias, -bias], device=m.device)
            levels = []
            with patch.object(vox_mod, "fsq", fsq_levels(levels, vox_mod.fsq)), \
                    torch.inference_mode():
                out, n_steps, _ = vox_mod.generate_patches(
                    m.params, cut, arr, n, ref_pad, n_ref, starts.to(m.device),
                    VOX_CHECK_PATCHES, torch.float32)
            runs[where, bias] = (out.double().cpu(), int(n_steps), levels)
    (h_out, h_n, h_lv), (c_out, c_n, c_lv) = runs["host", VOX_STOP_BIAS], runs["card", VOX_STOP_BIAS]
    first_part, tie = None, None
    for i, (a, b) in enumerate(zip(h_lv, c_lv)):
        differ = (torch.round(a) != torch.round(b)).nonzero()
        if len(differ):
            first_part = i
            tie = max(abs(abs(a[tuple(j)].item()) % 1.0 - 0.5) for j in differ)
            break
    # the step-i FSQ feeds step i + 1's patch: patches up to the parting's own step compare
    upto = h_n if first_part is None else first_part + 1
    per_step = [(c_out[i] - h_out[i]).abs().max().item() / h_out[i].abs().max().item()
                for i in range(upto)]
    live = runs["host", None][1], runs["card", None][1]
    with torch.inference_mode():
        lat = h_out[:h_n].reshape(1, -1, cut.latent_dim).float()
        wav = [vae_decode(m.params["audio_vae"], cut.vae, lat.to(m.device)).double().cpu()
               for m in (host, card)]
        exact = vae_decode(tree_to(card.params["audio_vae"], dev, torch.float64), cut.vae,
                           lat.to(dev, torch.float64)).cpu()
    rel_wav = rel_l2(wav[1], wav[0])
    host_prec, card_prec = rel_l2(wav[0], exact), rel_l2(wav[1], exact)
    log(f"voxcpm2 (a) 2 + 1 + 1 + 1 layers, fp32, stop head off: {c_n} patches on the card, "
        f"{h_n} on the host; each step's patch of max |host| up to "
        f"{'the end' if first_part is None else f'step {first_part + 1}'}: at most "
        f"{max(per_step):.3e} (tol {VOX_TOL:g}; first {per_step[0]:.3e}); first FSQ parting "
        f"{'none' if first_part is None else f'at step {first_part}, the host within {tie:.2e} of x.5'}"
        f" (tol {VOX_TIE:g}); stop head live: n_steps host {live[0]}, card {live[1]}; the VAE "
        f"decode of {lat.shape[1]} latents card vs host rel L2 {rel_wav:.3e} (tol "
        f"{VOX_WAV_TOL:g}), from a float64 decode card {card_prec:.3e}, host {host_prec:.3e} "
        f"(card tol {VOX_PREC_RATIO:g} x host); {time.perf_counter() - t0:.1f} s with the host's "
        f"share")
    if not (c_n == h_n and max(per_step) <= VOX_TOL and (tie is None or tie <= VOX_TIE)
            and live[0] == live[1] and rel_wav <= VOX_WAV_TOL
            and card_prec <= VOX_PREC_RATIO * host_prec):
        raise AssertionError(f"voxcpm2 card vs host: patches {c_n}/{h_n}, per step "
                             f"{max(per_step)}, FSQ parting {first_part} ({tie}), live n_steps "
                             f"{live}, VAE {rel_wav}, from float64 {card_prec} vs {host_prec}")
    del card, host, runs, wav

    # (b) the full model, drawn on the card, bf16 (from_pretrained's dtype)
    t0 = time.perf_counter()
    model = VoxCPM2TTS.init_random_on_device(cfg, 0, device=dev, dtype=torch.bfloat16)
    model.params["stop_head"]["bias"] = torch.tensor([VOX_STOP_BIAS, -VOX_STOP_BIAS], device=dev)
    torch.cuda.synchronize()
    log(f"voxcpm2 weights: CONFIG_2B drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"bf16 with the VAE in fp32: {param_bytes(model.params) / 2 ** 30:.2f} GiB")
    model.synthesize("warm up", max_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    stages = {}
    with patch.multiple(vox_mod, prefill=timed(stages, "prefill", vox_mod.prefill),
                        vae_decode=timed(stages, "vae", vox_mod.vae_decode)):
        t0 = time.perf_counter()
        chunk = model.synthesize(VOX_TEXT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_patch = len(chunk.samples) // per_patch
    audio_s = len(chunk.samples) / chunk.sample_rate
    loop_s = wall - stages["vae"]
    log(f"voxcpm2 (b) CONFIG_2B bf16: {n_patch} patches ({model.last_loop['steps_run']} run, "
        f"{model.last_loop['stop_reads']} host reads of the stop flag), {audio_s:.2f} s of audio "
        f"in {wall:.3f} s: RTF {wall / audio_s:.3f}; prefill {1e3 * stages['prefill']:.1f} ms; "
        f"patch loop {n_patch / (loop_s - stages['prefill']):.2f} patches/s (real time 6.25); "
        f"VAE decode {1e3 * stages['vae'] / audio_s:.1f} ms a second of audio; peak memory "
        f"{peak:.2f} GiB ({resident:.2f} resident before it); on {dev_name} ({power})")
    if not (n_patch == VOX_TOKENS and len(chunk.samples) == n_patch * per_patch
            and np.isfinite(chunk.samples).all()):
        raise AssertionError(f"voxcpm2: {len(chunk.samples)} samples, finite "
                             f"{np.isfinite(chunk.samples).all()}")

    def lm_range(lm, x, positions, mask, cache, dims, *rest):
        if x.shape[1] > 1:
            return "vox.prefill"
        return "vox.base" if dims.rope else "vox.residual"

    def enc_range(p, cfg_, patches):
        return "vox.prefill" if patches.shape[1] > 1 else "vox.locenc"

    with patch.multiple(vox_mod, _lm_forward=ranged("", vox_mod._lm_forward, lm_range),
                        loc_enc=ranged("", vox_mod.loc_enc, enc_range),
                        cfm_sample=ranged("vox.cfm", vox_mod.cfm_sample),
                        _stop_logits=ranged("vox.stop", vox_mod._stop_logits),
                        vae_decode=ranged("vox.vae", vox_mod.vae_decode)):
        ranges, _, kernels, prof_wall = range_device_ms(
            lambda: model.synthesize(VOX_TEXT, max_tokens=VOX_SPLIT_PATCHES), "vox.")
    busy = sum(kernels.values()) / 1e3
    f = VOX_SPLIT_PATCHES
    log(f"voxcpm2 under the profiler ({f} patches): wall {prof_wall:.3f} s, device busy "
        f"{busy:.2f} ms (idle {100 * (1 - busy / 1e3 / prof_wall):.1f} %); prefill "
        f"{ranges.get('prefill', 0.0):.3f} ms once; device ms a patch: CFM "
        f"{ranges.get('cfm', 0.0) / f:.3f}, LocEnc {ranges.get('locenc', 0.0) / f:.3f}, base LM "
        f"{ranges.get('base', 0.0) / f:.3f}, residual LM {ranges.get('residual', 0.0) / f:.3f}, "
        f"stop {ranges.get('stop', 0.0) / f:.3f}, other {ranges.get('other', 0.0) / f:.3f}; VAE "
        f"{ranges.get('vae', 0.0):.3f} ms for {f * per_patch / cfg.sample_rate:.2f} s; on "
        f"{dev_name} ({power})")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]:
        log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")

    t = np.arange(int(VOX_VOICE_S * 48000)) / 48000
    ref_audio = (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    t0 = time.perf_counter()
    cloned = model.synthesize(VOX_TEXT, voice=ref_audio, max_tokens=8).samples
    clone_s = time.perf_counter() - t0
    designed = model.synthesize(VOX_TEXT, instruct="a calm low voice", max_tokens=8).samples
    ref_patches = model.encode_reference(ref_audio)
    log(f"voxcpm2 cloned: {VOX_VOICE_S:g} s of reference -> {ref_patches.shape[0]} patches, "
        f"{len(cloned) // per_patch} patches out in {clone_s:.3f} s; instruct: "
        f"{len(designed) // per_patch} patches; finite {np.isfinite(cloned).all()} "
        f"{np.isfinite(designed).all()}")
    if not (len(cloned) == len(designed) == 8 * per_patch and np.isfinite(cloned).all()
            and np.isfinite(designed).all()
            and ref_patches.shape == (-(-int(VOX_VOICE_S * cfg.vae.sample_rate)
                                        // (cfg.patch_size * cfg.chunk_size)),
                                      cfg.patch_size, cfg.latent_dim)):
        raise AssertionError(f"voxcpm2 voice/instruct: {len(cloned)}/{len(designed)} samples, "
                             f"reference patches {ref_patches.shape}")
    check_counters_still("voxcpm2", counters, before)
    log(f"voxcpm2: phase {time.perf_counter() - t_phase:.1f} s")
    return model


def phase_speak_engines(asr, engines, counters, dev_name, power):
    """``POST /speak`` with ``engine`` set to each of ``engines`` (the
    registry entries ``tts:<engine>``) under the group scheduler and the
    slot pool: each answer through a ``TTSBatcher`` (the pool is only for
    models with a talker and a code predictor) and equal, byte for byte, to
    the WAV of a direct ``synthesize`` of the same text and seed."""
    from qwen3_asr_swift_tpu_torch.audio.io import wav_bytes
    from qwen3_asr_swift_tpu_torch.serving import SpeechServer, TTSBatcher, build_registry

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    want = {}
    for name, model in engines.items():
        chunk = model.synthesize(SPEAK_ENGINE_TEXTS[name])
        want[name] = wav_bytes(chunk.samples, chunk.sample_rate)
    for scheduler in ("group", "slotpool"):
        registry = build_registry(asr)
        for name, model in engines.items():
            registry.register_instance(f"tts:{name}", model)
        server = SpeechServer(registry, port=0, scheduler=scheduler, max_batch=4)
        with Serving(server) as port:
            for name, model in engines.items():
                t0 = time.perf_counter()
                status, ctype, body = post(port, "/speak", json.dumps(
                    {"text": SPEAK_ENGINE_TEXTS[name], "engine": name}).encode(),
                    "application/json")
                wall = time.perf_counter() - t0
                batcher = server._tts_batcher_for(model)
                log(f"speak ({scheduler}, engine {name}): {status} {ctype}, {len(body)} bytes in "
                    f"{wall:.2f} s through {type(batcher).__name__} "
                    f"{json.dumps(batcher.stats)}; equal to the direct synthesize "
                    f"{body == want[name]}; on {dev_name} ({power})")
                if not (status == 200 and type(batcher) is TTSBatcher and body == want[name]):
                    raise AssertionError(f"speak ({scheduler}, {name}): {status}, "
                                         f"{type(batcher).__name__}, equal {body == want[name]}")
    check_counters_still("speak (engines)", counters, before)
    log(f"speak (engines): phase {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------- #
# the server's last routes: /v1/realtime over the ASR and TTS models,
# /enhance (DeepFilterNet3) and /respond (PersonaPlex 7B with Mimi)

REALTIME_TOKENS = 32     # the ASR model's default budget on the realtime path (depth cut)
REALTIME_FRAMES = 24     # the TTS model's default frame cap there (1.92 s)
REALTIME_WAIT_S = 600     # the client socket's timeout
REALTIME_TEXT = "The realtime route speaks this sentence."
ENHANCE_S = 10           # seconds of noisy 48 kHz audio
ENHANCE_TOL = 1e-4       # card vs host CPU, of max |host|, fp32 both
ENHANCE_STREAM_TOL = 1e-5  # 100 ms pushes vs the batch pass, of max |batch|, on the card
RESPOND_TOL = 5e-2       # first frame's text and codebook-0 logits, relative L2, card vs host
RESPOND_USER_S = 4       # seconds of user audio (50 frames)
RESPOND_STEPS = 75       # the greedy response's frame budget
# the profiled response: the profiler's event tree costs seconds of host a
# frame, so few frames
RESPOND_SPLIT_FRAMES = 4
RESPOND_SERVE_STEPS = 12
#: K1's products on the PersonaPlex 7B frame: (name, in, out, calls a frame)
PERSONAPLEX_K1_SHAPES = [("qkv", 4096, 12288, 32), ("o", 4096, 4096, 32),
                         ("gate_up", 4096, 22528, 32), ("down", 11264, 4096, 32),
                         ("text head", 4096, 32001, 1)]


class Serving:
    """A ``SpeechServer`` on its own event-loop thread: ``with
    Serving(server) as port``; stopped (batchers shut down) on exit."""

    def __init__(self, server):
        import asyncio
        import threading

        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)

    def __enter__(self):
        import asyncio

        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.server.start(), self.loop).result(timeout=30)
        return self.server._server.sockets[0].getsockname()[1]

    def __exit__(self, *exc):
        import asyncio

        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


def post(port, path, body: bytes, ctype: str):
    """(status, content type, body) of one POST."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type", ""), resp.read()
    finally:
        conn.close()


def phase_realtime(asr, tts, counters, dev_name, power):
    """``/v1/realtime`` on a server with the ASR model of phase serve (the
    slice's: packed, int8 KV) and the TTS model of phase speak (1.7B,
    ``"fused"``): a stdlib client (masked frames) appends 8 s of PCM16 in
    100 ms pieces and commits; the transcript must equal what
    ``/transcribe`` answers for the same samples at the same budget (the
    depth is cut through the model's default, ``Qwen3ASR.max_tokens``, that
    a commit decodes to). Then ``conversation.item.create`` and
    ``response.create`` must give ``response.created``, audio deltas,
    ``response.audio.done`` and ``response.done`` "completed", and the
    deltas must be the PCM16 of the model's own ``synthesize_stream`` of the
    text, run directly. K1 and K3 must run under the commit, K1 under the
    response."""
    import base64

    import torch

    from qwen3_asr_swift_tpu_torch.core.types import to_pcm16
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts import TTSSamplingConfig
    from qwen3_asr_swift_tpu_torch.serving import ContinuousBatcher, SpeechServer, build_registry
    from qwen3_asr_swift_tpu_torch.serving.ws import SyncWSClient

    k1c, k3c = counters
    rng = np.random.default_rng(5)
    t = np.arange(8 * SR) / SR
    audio = (0.3 * np.sin(2 * np.pi * 180 * t) * ((t % 1.0) < 0.6)
             + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    pcm = to_pcm16(audio).tobytes()
    step = SR // 10 * 2
    saved = asr.max_tokens, tts.sampling
    asr.max_tokens = REALTIME_TOKENS
    tts.sampling = TTSSamplingConfig(temperature=0.0, top_k=0, max_frames=REALTIME_FRAMES)
    try:
        server = SpeechServer(build_registry(asr, tts), port=0)
        with Serving(server) as port:
            client = SyncWSClient("127.0.0.1", port, timeout=REALTIME_WAIT_S)
            types = [client.recv_json()["type"]]

            def until(kind):
                got = []
                while not got or got[-1]["type"] != kind:
                    got.append(client.recv_json())
                    if got[-1]["type"] == "error":
                        raise AssertionError(f"realtime: error event {got[-1]}")
                types.extend(e["type"] for e in got)
                return got

            client.send_json({"type": "session.update",
                              "session": {"input_audio_sample_rate": SR}})
            until("session.updated")
            torch.cuda.synchronize()
            k1c.reset()
            k3c.reset()
            t0 = time.perf_counter()
            for off in range(0, len(pcm), step):
                client.send_json({"type": "input_audio_buffer.append",
                                  "audio": base64.b64encode(pcm[off:off + step]).decode()})
            client.send_json({"type": "input_audio_buffer.commit"})
            transcript = until("conversation.item.input_audio_transcription.completed"
                               )[-1]["transcript"]
            t_commit = time.perf_counter() - t0
            asr_launches = (k1c.value, k3c.value)
            client.send_json({"type": "conversation.item.create", "item": {
                "content": [{"type": "input_text", "text": REALTIME_TEXT}]}})
            until("conversation.item.created")
            t0 = time.perf_counter()
            client.send_json({"type": "response.create"})
            events = until("response.done")
            t_response = time.perf_counter() - t0
            tts_launches = k1c.value - asr_launches[0]
            client.close()
            body = json.dumps({"audio_base64": base64.b64encode(pcm).decode(),
                               "sample_rate": SR, "max_tokens": REALTIME_TOKENS}).encode()
            status, _, answer = post(port, "/transcribe", body, "application/json")
            batcher = server._batcher_for(asr)
        direct = np.concatenate([c.samples for c in tts.synthesize_stream(REALTIME_TEXT)])
    finally:
        asr.max_tokens, tts.sampling = saved
    served = json.loads(answer)["text"] if status == 200 else None
    kinds = [e["type"] for e in events]
    deltas = [base64.b64decode(e["delta"]) for e in events if e["type"] == "response.audio.delta"]
    got = b"".join(deltas)
    want = to_pcm16(direct).tobytes()
    log(f"realtime: {len(pcm) // step} appends of 100 ms, commit → transcript in {t_commit:.2f} s "
        f"({REALTIME_TOKENS}-token budget; K1 {asr_launches[0]}, K3 {asr_launches[1]} launches); "
        f"/transcribe {status}, same text {transcript == served}: {transcript[:60]!r}")
    log(f"realtime: response in {t_response:.2f} s: {len(deltas)} deltas, "
        f"{len(got) // 2 / 24000:.2f} s of audio, equal to synthesize_stream {got == want} "
        f"({len(want) // 2} samples); K1 {tts_launches} launches; events {types[:4]} ... "
        f"{types[-3:]}; {type(batcher).__name__} stats {json.dumps(batcher.stats)}; on "
        f"{dev_name} ({power})")
    if status != 200 or transcript != served:
        raise AssertionError(f"realtime transcript {transcript!r} != /transcribe {served!r}")
    if kinds[0] != "response.created" or kinds[-2:] != ["response.audio.done", "response.done"] \
            or events[-1]["response"] != {"status": "completed"} or not deltas:
        raise AssertionError(f"realtime response events {kinds[:3]} ... {kinds[-3:]}")
    if got != want:
        raise AssertionError(f"realtime deltas ({len(got)} bytes) differ from synthesize_stream "
                             f"({len(want)} bytes)")
    if not (asr_launches[0] > 0 and asr_launches[1] > 0 and tts_launches > 0):
        raise AssertionError(f"realtime launches: commit K1/K3 {asr_launches}, response K1 "
                             f"{tts_launches}")
    if not isinstance(batcher, ContinuousBatcher) or batcher.stats["requests_served"] != 2:
        raise AssertionError(f"realtime batcher {type(batcher).__name__} {batcher.stats}")


def phase_enhance(dev_name, power):
    """DeepFilterNet3 at its published widths (random, seed 0) on
    ``ENHANCE_S`` s of noisy 48 kHz audio: card vs host CPU (fp32 both)
    within ``ENHANCE_TOL`` of max |host|; ``StreamingEnhancer`` on the card
    in 100 ms pushes within ``ENHANCE_STREAM_TOL`` of the card's batch
    output; ``POST /enhance`` answers 200 and a WAV of the same length; ms
    a second of audio."""
    import torch

    from qwen3_asr_swift_tpu_torch.audio.io import read_wav, wav_bytes
    from qwen3_asr_swift_tpu_torch.models.enhancement import SpeechEnhancer, StreamingEnhancer
    from qwen3_asr_swift_tpu_torch.serving import SpeechServer, build_registry

    rate = 48000
    rng = np.random.default_rng(6)
    t = np.arange(ENHANCE_S * rate) / rate
    speech = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t) ** 2
    noisy = (speech + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    card = SpeechEnhancer.init_random(0, device="cuda")
    card.enhance(noisy[:rate], rate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = card.enhance(noisy, rate).samples
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = SpeechEnhancer.init_random(0, device="cpu").enhance(noisy, rate).samples
    host_wall = time.perf_counter() - t0
    scale = np.abs(ref).max()
    rel = np.abs(out - ref).max() / scale
    stream = StreamingEnhancer(card)
    pushes, parts = [], []
    for off in range(0, len(noisy), rate // 10):
        t0 = time.perf_counter()
        parts.append(stream.push(noisy[off:off + rate // 10]))
        pushes.append(time.perf_counter() - t0)
    parts.append(stream.flush())
    streamed = np.concatenate(parts)[: len(out)]
    s_rel = np.abs(streamed - out).max() / np.abs(out).max()
    server = SpeechServer(build_registry(enhance=card), port=0)
    with Serving(server) as port:
        status, ctype, body = post(port, "/enhance", wav_bytes(noisy, rate), "audio/wav")
    wav, wav_rate = read_wav(body) if status == 200 else (np.zeros(0), 0)
    log(f"enhance: DFN3 (published widths, random seed 0), {ENHANCE_S} s at 48 kHz: card "
        f"{1e3 * wall / ENHANCE_S:.1f} ms a second of audio ({wall:.3f} s), host CPU "
        f"{1e3 * host_wall / ENHANCE_S:.1f} ms; card vs host max err {rel:.3e} of max |host| "
        f"(tol {ENHANCE_TOL:g}); streamed (100 ms pushes, p50 "
        f"{1e3 * np.median(pushes):.1f} ms, p90 {1e3 * np.percentile(pushes, 90):.1f} ms) vs "
        f"batch {s_rel:.3e} (tol {ENHANCE_STREAM_TOL:g}); POST /enhance {status} {ctype}, "
        f"{len(wav)} samples at {wav_rate} Hz; on {dev_name} ({power})")
    if len(out) != len(noisy) or not np.isfinite(out).all() or not rel <= ENHANCE_TOL:
        raise AssertionError(f"enhance: {len(out)} samples, card vs host {rel}")
    if len(streamed) != len(out) or not s_rel <= ENHANCE_STREAM_TOL:
        raise AssertionError(f"enhance: streamed vs batch {s_rel} ({len(streamed)} samples)")
    if status != 200 or ctype != "audio/wav" or wav_rate != rate or len(wav) != len(noisy):
        raise AssertionError(f"POST /enhance: {status} {ctype}, {len(wav)} samples at {wav_rate}")


def respond_k1_launches(cfg, frames: int, prefill_rows: int) -> int:
    """K1's launches in one ``respond`` of ``frames`` frames (every frame
    the loop ran) from the code: the prompt prefill's products (qkv, o,
    gate_up and down a layer) when it has at most 256 rows, and each
    frame's temporal step (the same four a layer) and text head. The
    depformer's banks and Mimi are dense."""
    from qwen3_asr_swift_tpu_torch.ops.quant import KERNEL_MAX_ROWS

    per_frame = 4 * cfg.num_layers + 1
    return (4 * cfg.num_layers if prefill_rows <= KERNEL_MAX_ROWS else 0) + frames * per_frame


def respond_user_audio(seconds: float, seed: int = 7, rate: int = 24000) -> np.ndarray:
    """A voiced 150 Hz tone gated at 2 Hz, with noise: the user's turn."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    voiced = 0.25 * np.sin(2 * np.pi * 150 * t) * (np.sin(2 * np.pi * 2 * t) > 0)
    return (voiced + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def respond_first_frame(model, user, text_token=None, dep_tokens=None):
    """The first generated frame's text logits and the depformer's
    codebook-0 logits (fp32, host), fed the given text token and depformer
    tokens (else the greedy text token and the user's first Mimi frame):
    (text logits, codebook-0 logits, text token, depformer tokens, user
    codes)."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.personaplex import model as pp

    cfg, dev = model.cfg, model.device
    k = cfg.temporal_codebooks
    with torch.inference_mode():
        uc, n_frames, ve, nv, reads, n_prompt = model._conversation_inputs(user, 24000, None,
                                                                           None)
        cache = model._prefill(uc, ve, nv, reads, n_prompt, 1)
        sine = torch.tensor(pp.SINE_TOKENS[:k], device=dev)[None]
        user_read = pp.user_stream_reads(uc, sine, 0, n_frames, k)
        silence = torch.tensor(pp.SILENCE_TOKENS[:k], device=dev)[None]
        pad = torch.full((1,), cfg.text_pad, dtype=torch.long, device=dev)
        hidden, text_logits = model._frame_hidden(cache, pad, user_read, silence)
        if text_token is None:
            text_token = int(text_logits.argmax(-1)[0])
        if dep_tokens is None:
            dep_tokens = uc[:, :, 0].cpu()
        dep = pp.depformer_forward_logits(model.params, cfg, hidden,
                                          torch.tensor([text_token], device=dev),
                                          dep_tokens.to(dev))
    return text_logits[0].float().cpu(), dep[0, 0].float().cpu(), text_token, dep_tokens, uc.cpu()


def respond_split(model, user, sampling):
    """One ``respond`` under the profiler with the prefill, the temporal
    steps, the depformer and Mimi's encode and decode in ranges of their
    own: ({range: device ms}, {kernel: device µs}, wall s, frames run, K1's
    device ms in the frames (temporal steps and text heads), K1's in the
    prefill)."""
    from qwen3_asr_swift_tpu_torch.models.personaplex import model as pp

    names = ("temporal_prefill", "temporal_step", "depformer_generate", "mimi_encode",
             "mimi_decode")
    by_range = {}
    with patch.multiple(pp, **{k: ranged(f"pp.{k}", getattr(pp, k)) for k in names}):
        ms, _, kernels, wall = range_device_ms(
            lambda: model.respond(user, 24000, sampling=sampling), "pp.", by_range)

    def k1_ms(*ranges):
        return sum(us for r in ranges for name, us in by_range.get(r, {}).items()
                   if "::quant_matmul_kernel<" in name or "::split_sum(" in name) / 1e3

    return (ms, kernels, wall, model.last_loop["frames_run"],
            k1_ms("temporal_step", "other"), k1_ms("temporal_prefill"))


def phase_respond(dev, k1_counter, dev_name, power):
    """PersonaPlex at ``CONFIG_7B`` with Mimi at its published widths
    (random weights drawn on the card from a seeded ``torch.Generator``,
    the temporal stack and text head packed 4-bit group 64 as drawn):
    (a) a full-width model cut to 2 temporal layers, fp32, card vs host
    CPU: the first frame's text and codebook-0 logits within ``RESPOND_TOL``
    relative L2 (the host cannot hold the fp32 7B); (b) the 7B in bf16: one
    greedy ``respond`` of ``RESPOND_USER_S`` s of user audio, the default
    system prompt, no voice prompt, ``RESPOND_STEPS`` frames: K1's launches
    must equal ``respond_k1_launches``; frames/s, RTF, device ms a frame by
    range, peak device memory; (c) ``POST /respond``: 200 and a WAV, and
    ``format: "json"`` with ``text_token_ids`` and the audio of a direct
    ``respond`` with the same seed; 503 from a server without ``s2s``.
    Returns (K1's launches in (b), K1's frame timing)."""
    import base64
    import dataclasses
    import gc

    import torch

    from qwen3_asr_swift_tpu_torch.audio.io import read_wav, wav_bytes
    from qwen3_asr_swift_tpu_torch.core.params import param_bytes
    from qwen3_asr_swift_tpu_torch.core.types import to_float32, to_pcm16
    from qwen3_asr_swift_tpu_torch.models.personaplex import (CONFIG_7B, PersonaPlex,
                                                              PersonaSampling)
    from qwen3_asr_swift_tpu_torch.serving import SpeechServer, build_registry

    k1_frame_info = k1_frame(dev, PERSONAPLEX_K1_SHAPES, "respond", "PersonaPlex 7B")
    user = respond_user_audio(RESPOND_USER_S)

    # (a) card vs host, 2 temporal layers at full width, fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg2 = dataclasses.replace(CONFIG_7B, num_layers=2)
    t0 = time.perf_counter()
    card = PersonaPlex.init_random_on_device(cfg2, 0, device=dev, dtype=torch.float32,
                                             quant_bits=4)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = PersonaPlex(cfg2, tree_to(card.params, "cpu"), tree_to(card.mimi_params, "cpu"),
                       device="cpu", dtype=torch.float32)
    h_text, h_cb0, tok, dep_tokens, h_codes = respond_first_frame(host, user)
    t_host = time.perf_counter() - t0
    c_text, c_cb0, _, _, c_codes = respond_first_frame(card, user, tok, dep_tokens)
    rels = [(torch.linalg.vector_norm(c - h) / torch.linalg.vector_norm(h)).item()
            for c, h in ((c_text, h_text), (c_cb0, h_cb0))]
    log(f"respond (a): CONFIG_7B cut to 2 temporal layers, full depformer and Mimi, fp32, "
        f"packed 4-bit on the card in {t_build:.1f} s; first frame card vs host CPU: text "
        f"logits rel L2 {rels[0]:.3e}, codebook-0 logits rel L2 {rels[1]:.3e} (tol "
        f"{RESPOND_TOL:g}; host {t_host:.1f} s); greedy text token host {tok} card "
        f"{int(c_text.argmax())}; Mimi codes of {RESPOND_USER_S} s equal on "
        f"{(c_codes == h_codes).float().mean().item():.4f} of entries")
    if not max(rels) <= RESPOND_TOL:
        raise AssertionError(f"respond first-frame logits rel L2 {rels} > {RESPOND_TOL}")
    del card, host
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the 7B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = PersonaPlex.init_random_on_device(CONFIG_7B, 0, device=dev, dtype=torch.bfloat16,
                                              quant_bits=4)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"respond (b): CONFIG_7B (32 x 4096, FFN 11264, text vocab 32001; depformer 6 x 1024; "
        f"Mimi), random seed 0 drawn on the card, temporal stack and text head packed 4-bit "
        f"group 64, bf16: {param_bytes(model.params) / 2**30:.2f} GiB of LM weights, "
        f"{param_bytes(model.mimi_params) / 2**20:.1f} MiB of Mimi, built in {t_build:.1f} s")
    greedy = PersonaSampling(audio_temperature=0.0, text_temperature=0.0,
                             max_steps=RESPOND_STEPS)
    spf = model.cfg.mimi.samples_per_frame
    model.respond(user[:2 * spf], 24000, sampling=dataclasses.replace(greedy, max_steps=2))
    torch.cuda.synchronize()
    k1_counter.reset()
    t0 = time.perf_counter()
    out = model.respond(user, 24000, sampling=greedy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1_counter.value
    frames_run, reads = model.last_loop["frames_run"], model.last_loop["stop_reads"]
    n_done = len(out.samples) // spf
    prefill_rows = PersonaPlex.VOICE_PROMPT_CAP + PersonaPlex.PROMPT_CAP
    want = respond_k1_launches(CONFIG_7B, frames_run, prefill_rows)
    audio_s = len(out.samples) / out.sample_rate
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"respond (b): {RESPOND_USER_S} s of user audio → {n_done} frames ({frames_run} run, "
        f"{reads} host reads of the stop flag), {audio_s:.2f} s of audio in {wall:.3f} s: "
        f"{frames_run / wall:.2f} frames/s, RTF {wall / audio_s:.3f}; K1 launches {launches}, "
        f"from the code {want} (prefill {prefill_rows} rows); text tokens "
        f"{model.last_text_tokens[:12].tolist()}...; peak device memory {peak:.2f} GiB; on "
        f"{dev_name} ({power})")
    if n_done == 0 or len(out.samples) != n_done * spf or not np.isfinite(out.samples).all():
        raise AssertionError(f"respond: {len(out.samples)} samples for {n_done} frames")
    if launches != want:
        raise AssertionError(f"respond: K1 launched {launches} times, the code says {want}")
    ranges, kernels, prof_wall, run_f, k1_frames, k1_prefill = respond_split(
        model, user, dataclasses.replace(greedy, max_steps=RESPOND_SPLIT_FRAMES))
    busy = sum(kernels.values()) / 1e3
    log(f"respond under the profiler ({run_f} frames): wall {prof_wall:.3f} s, device busy "
        f"{busy:.2f} ms (idle {100 * (1 - busy / 1e3 / prof_wall):.1f} %); device ms a frame: "
        f"temporal step {ranges.get('temporal_step', 0.0) / run_f:.3f}, depformer "
        f"{ranges.get('depformer_generate', 0.0) / run_f:.3f}, outside the ranges (text head, "
        f"sampling, embeddings) {ranges.get('other', 0.0) / run_f:.3f}; once: prefill "
        f"{ranges.get('temporal_prefill', 0.0):.3f}, Mimi encode "
        f"{ranges.get('mimi_encode', 0.0):.3f}, Mimi decode {ranges.get('mimi_decode', 0.0):.3f}; "
        f"K1 {k1_frames / run_f:.3f} ms a frame (bound {k1_frame_info['bound_ms']:.4f}), "
        f"{k1_prefill:.3f} ms in the prefill; wall a "
        f"frame {1e3 * wall / frames_run:.1f} ms unprofiled; on {dev_name} ({power})")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")

    # (c) POST /respond
    pcm = to_pcm16(respond_user_audio(2.0, seed=8, rate=SR))
    body = {"audio_base64": base64.b64encode(pcm.tobytes()).decode(), "sample_rate": SR,
            "max_steps": RESPOND_SERVE_STEPS, "seed": 7}
    server = SpeechServer(build_registry(s2s=model), port=0)
    with Serving(server) as port:
        t0 = time.perf_counter()
        status_wav, ctype, wav_body = post(port, "/respond", json.dumps(body).encode(),
                                           "application/json")
        status_json, _, json_body = post(port, "/respond",
                                         json.dumps(dict(body, format="json")).encode(),
                                         "application/json")
        t_serve = time.perf_counter() - t0
    with Serving(SpeechServer(build_registry(), port=0)) as port:
        status_none, _, none_body = post(port, "/respond", json.dumps(body).encode(),
                                         "application/json")
    direct = model.respond(to_float32(pcm), SR, sampling=PersonaSampling(
        max_steps=RESPOND_SERVE_STEPS), seed=7)
    served = json.loads(json_body) if status_json == 200 else {}
    served_audio = read_wav(base64.b64decode(served.get("audio_base64", "")))[0] \
        if served else np.zeros(0)
    wav = read_wav(wav_body)[0] if status_wav == 200 else np.zeros(0)
    want_audio = read_wav(wav_bytes(direct.samples, 24000))[0]
    same = np.array_equal(served_audio, want_audio)
    log(f"respond (c): POST /respond {status_wav} {ctype} ({len(wav)} samples), format json "
        f"{status_json} with {len(served.get('text_token_ids', []))} text token ids, audio equal "
        f"to respond(seed=7) {same}, ids equal {served.get('text_token_ids') == model.last_text_tokens.tolist()}; "
        f"both in {t_serve:.2f} s; without s2s: {status_none} {none_body[:60]!r}")
    if status_wav != 200 or ctype != "audio/wav" or len(wav) != RESPOND_SERVE_STEPS * spf:
        raise AssertionError(f"POST /respond: {status_wav} {ctype}, {len(wav)} samples")
    if (status_json != 200 or not same
            or served.get("text_token_ids") != model.last_text_tokens.tolist()):
        raise AssertionError(f"POST /respond json: {status_json}, audio equal {same}")
    if status_none != 503:
        raise AssertionError(f"POST /respond without s2s: {status_none}")
    k1_frame_info.update(frames=frames_run, in_respond_device_ms=k1_frames / run_f)
    return launches, k1_frame_info, model


CHAT_TOL = 5e-2          # first-step logits, relative L2, card vs host CPU (phase step's limit)
CHAT_TOKENS = 64         # the greedy generation's budget (depth cut)
CHAT_SPLIT_TOKENS = 4    # tokens under the profiler
CHAT_PROMPT = "Tell me about the weather on the coast today, in two short sentences please."
#: K1's products of one Qwen3.5 0.8B token: (name, in, out, calls a token)
CHAT_K1_SHAPES = [("deltanet qkv", 1024, 6144, 18), ("deltanet z", 1024, 2048, 18),
                  ("deltanet out", 2048, 1024, 18), ("attn q+gate", 1024, 4096, 6),
                  ("attn k", 1024, 512, 6), ("attn v", 1024, 512, 6), ("attn o", 2048, 1024, 6),
                  ("mlp gate", 1024, 3072, 24), ("mlp up", 1024, 3072, 24),
                  ("mlp down", 3072, 1024, 24), ("tied head", 1024, 151936, 1)]
AGENT_SPEECH_S = 3.0     # seconds of speech-like audio fed to the agent, then silence
AGENT_SILENCE_S = 1.5
AGENT_STT_TOKENS = 32    # the ASR's budget on the agent's path (as realtime's)
AGENT_CHAT_TOKENS = 64   # the chat's generation budget on the agent's path
AGENT_TTS_FRAMES = 24    # the TTS model's frame cap on the agent's path (as realtime's)
AGENT_WAIT_S = 600
DUPLEX_TOL = 5e-2        # sampler logits up to the first parting, relative L2
DUPLEX_BATCH_FRAMES = 16  # frames of the batch-2 comparison
DUPLEX_SPLIT_FRAMES = 4   # frames under the profiler


def chat_vocab_tokenizer(vocab_size: int, im_start: int, im_end: int):
    """The CLI's byte-level chat tokenizer grown to a Qwen-sized vocabulary:
    its 256 byte tokens, the chat template's two specials at their Qwen
    ids, and every other id a token of three printable characters, so a
    random model's reply decodes to text (ASCII) instead of vanishing."""
    from qwen3_asr_swift_tpu_torch.cli import chat_tokenizer
    from qwen3_asr_swift_tpu_torch.tokenizers.bpe import BPETokenizer

    base = chat_tokenizer(256)
    vocab = dict(base.vocab)
    enc = base.byte_encoder
    letters = [enc[b] for b in range(ord("a"), ord("z") + 1)] + [enc[ord(" ")]] + \
        [enc[b] for b in range(ord("A"), ord("Z") + 1)] + [enc[b] for b in range(ord("0"), ord("9") + 1)]
    n = len(letters)
    i = 0
    for tid in range(256, vocab_size):
        if tid in (im_start, im_end):
            continue
        while True:
            tok = letters[i // (n * n) % n] + letters[i // n % n] + letters[i % n]
            i += 1
            if tok not in vocab:
                break
        vocab[tok] = tid
    return BPETokenizer(vocab, [], {"<|im_start|>": im_start, "<|im_end|>": im_end})


def chat_split(model, ids, tokens: int):
    """The prefill, then ``tokens`` decode steps, each under the profiler,
    the DeltaNet layers, the gated-attention layers, the MLPs and the tied
    head in ranges of their own: ((prefill device ms, prefill wall s),
    {range: device ms of the decode}, {kernel: µs of the decode}, decode
    wall s)."""
    from qwen3_asr_swift_tpu_torch.models.chat import model as chat

    names = ("deltanet_forward", "gated_attention_forward", "_swiglu_mlp", "tied_lm_head")
    x, n_valid, t_bucket = model._prompt(ids)
    state = {}

    def prefill():
        state["s"] = model._gen_start(x, n_valid, tokens + 1, t_bucket + tokens + 1, None, None)

    with patch.multiple(chat, **{k: ranged(f"chat.{k}", getattr(chat, k)) for k in names}):
        pre_ms, _, _, pre_wall = range_device_ms(prefill, "chat.")
        ms, _, kernels, wall = range_device_ms(
            lambda: model._gen_chunk(state["s"], n_valid, tokens + 1), "chat.")
    return (sum(pre_ms.values()), pre_wall), ms, kernels, wall


def phase_chat(dev, k1_counter, dev_name, power):
    """Qwen3.5 chat at ``CONFIG_08B`` (hidden 1024, 24 layers: 18 DeltaNet and
    6 gated attention; vocab 151,936), random weights drawn on the card from
    seed 0, packed 4-bit group 64 (every eligible linear and the tied table)
    as drawn: K1 at the token's product shapes (rows 1, bf16 x) with bound
    and ``torch.mm`` yardstick summed over a token; the full-width model cut
    to 2 layers (one DeltaNet, one gated attention), fp32, first-step logits
    card vs host CPU within ``CHAT_TOL`` relative L2; the 0.8B in bf16:
    greedy ``generate_ids_stream`` equal to ``generate_ids`` token for token,
    K1's launches the count from the code (the packed products a row-block
    × the steps run: the prompt's bucketed prefill and each token), tokens/s, device ms
    a token by range, idle share. Returns (the bf16 model, K1's launches,
    K1's token timing)."""
    import dataclasses
    import gc

    import torch

    from qwen3_asr_swift_tpu_torch.core.params import param_bytes
    from qwen3_asr_swift_tpu_torch.models.chat import CONFIG_08B, Qwen3Chat
    from qwen3_asr_swift_tpu_torch.models.chat import model as chat

    k1_token = k1_frame(dev, CHAT_K1_SHAPES, "chat", "Qwen3.5 0.8B")

    # card vs host, 2 layers at full width, fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg2 = dataclasses.replace(CONFIG_08B, num_layers=2, full_attention_interval=2)
    card = Qwen3Chat.init_random_on_device(cfg2, 0, quant_bits=4, device=dev,
                                           dtype=torch.float32)
    host = Qwen3Chat(cfg2, tree_to(card.params, "cpu"), device="cpu", dtype=torch.float32)
    tok = chat_vocab_tokenizer(cfg2.vocab_size, 151644, cfg2.eos_token_id)
    ids = tok.encode(Qwen3Chat.apply_chat_template([{"role": "user", "content": CHAT_PROMPT}]))
    logits = []
    for m in (card, host):
        x, n_valid, t_bucket = m._prompt(ids)
        pad = t_bucket - n_valid
        ar = torch.arange(t_bucket, device=m.device)[None]
        with torch.inference_mode():
            out, _ = chat.chat_forward(m.params, cfg2, x, chat.init_states(cfg2, 1, t_bucket,
                                                                           device=m.device),
                                       torch.clamp(ar - pad[:, None], min=0), ar >= pad[:, None])
        logits.append(out[0, -1].float().cpu())
    rel = (torch.linalg.vector_norm(logits[0] - logits[1])
           / torch.linalg.vector_norm(logits[1])).item()
    log(f"chat (a): CONFIG_08B cut to 2 layers (1 DeltaNet, 1 gated attention), packed 4-bit, "
        f"fp32, prompt of {len(ids)} tokens (bucket {t_bucket}): first-step logits card vs host "
        f"CPU rel L2 {rel:.3e} (tol {CHAT_TOL:g}); greedy token host "
        f"{int(logits[1].argmax())} card {int(logits[0].argmax())}")
    if not rel <= CHAT_TOL:
        raise AssertionError(f"chat first-step logits rel L2 {rel} > {CHAT_TOL}")
    del card, host
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = Qwen3Chat.init_random_on_device(CONFIG_08B, 0, quant_bits=4, device=dev,
                                            dtype=torch.bfloat16,
                                            tokenizer=chat_vocab_tokenizer(
                                                CONFIG_08B.vocab_size, 151644,
                                                CONFIG_08B.eos_token_id))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    per_block = chat.packed_products(model.params)
    log(f"chat (b): CONFIG_08B random seed 0 drawn on the card, packed 4-bit group 64, bf16: "
        f"{param_bytes(model.params) / 2**20:.1f} MiB, built in {t_build:.1f} s; "
        f"{per_block} packed products a row-block")
    model.generate_ids(ids, max_new=2)
    torch.cuda.synchronize()
    k1_counter.reset()
    t0 = time.perf_counter()
    toks = model.generate_ids(ids, max_new=CHAT_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, steps = k1_counter.value, model.last_loop["steps_run"]
    t0 = time.perf_counter()
    streamed, first = [], None
    for t in model.generate_ids_stream(ids, max_new=CHAT_TOKENS):
        first = first if first is not None else time.perf_counter() - t0
        streamed.append(t)
    stream_wall = time.perf_counter() - t0
    want = per_block * steps
    log(f"chat (b): {len(toks)} greedy tokens ({steps} steps) in {wall:.3f} s: "
        f"{steps / wall:.2f} tokens/s; stream: first token {1e3 * first:.1f} ms, all "
        f"{stream_wall:.3f} s, equal to generate_ids {streamed == toks}; K1 launches "
        f"{launches}, from the code {want} ({per_block} × {steps}); tokens {toks[:10]}...; "
        f"on {dev_name} ({power})")
    if streamed != toks:
        raise AssertionError("chat: generate_ids_stream differs from generate_ids")
    if launches != want or steps != CHAT_TOKENS:
        raise AssertionError(f"chat: K1 launched {launches} times in {steps} steps, "
                             f"the code says {want}")
    (pre_ms, pre_wall), ranges, kernels, prof_wall = chat_split(model, ids, CHAT_SPLIT_TOKENS)
    busy = sum(kernels.values()) / 1e3
    f = CHAT_SPLIT_TOKENS
    log(f"chat under the profiler: the prefill (bucket of {t_bucket} rows) {pre_ms:.3f} ms of "
        f"device in {1e3 * pre_wall:.1f} ms of wall; {f} decode steps: wall {prof_wall:.3f} s, "
        f"device busy {busy:.2f} ms (idle {100 * (1 - busy / 1e3 / prof_wall):.1f} %); device "
        f"ms a token: DeltaNet layers {ranges.get('deltanet_forward', 0.0) / f:.3f}, gated "
        f"attention {ranges.get('gated_attention_forward', 0.0) / f:.3f}, MLPs "
        f"{ranges.get('_swiglu_mlp', 0.0) / f:.3f}, tied head "
        f"{ranges.get('tied_lm_head', 0.0) / f:.3f}, other (norms, embedding, sampling) "
        f"{ranges.get('other', 0.0) / f:.3f}; K1 alone {k1_token['device_ms']} ms a token "
        f"(bound {k1_token['bound_ms']:.4f}); on {dev_name} ({power})")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")
    k1_token.update(tokens=steps)
    return model, launches, k1_token


class RecordingSTT:
    """Delegates to an ASR model and keeps the audio each ``transcribe``
    got, for the agent's check."""

    def __init__(self, model):
        self.model = model
        self.audio = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def transcribe(self, audio, **kw):
        self.audio.append(np.array(audio))
        return self.model.transcribe(audio, **kw)


def agent_audio(seed: int = 9) -> np.ndarray:
    """``AGENT_SPEECH_S`` s of a voiced 140 Hz tone gated at 2 Hz with noise,
    then ``AGENT_SILENCE_S`` s of quiet noise, at 16 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(AGENT_SPEECH_S * SR)) / SR
    voiced = 0.3 * np.sin(2 * np.pi * 140 * t) * (np.sin(2 * np.pi * 2 * t) > -0.3)
    quiet = np.zeros(int(AGENT_SILENCE_S * SR))
    audio = np.concatenate([voiced, quiet])
    return (audio + 0.005 * rng.standard_normal(len(audio))).astype(np.float32)


def phase_agent(asr, vad, llm, tts, counters, dev_name, power):
    """One turn of the voice agent: ``VoicePipeline`` (the C++ engine, built
    with g++) over the port's Silero on the card (its chunk program runs; an
    energy decision is laid over its random output, as the reference's own
    full-stack test does), the slice's packed 0.6B ASR with int8 KV (K1 and
    K3), phase chat's 0.8B (``AGENT_CHAT_TOKENS`` tokens) and phase tts's
    1.7B (``AGENT_TTS_FRAMES`` frames, greedy). The phase fails on any ERROR
    event, unless the final transcript is the ASR's direct ``transcribe`` of
    the samples its adapter got, the reply a direct greedy ``chat`` of the
    transcript, and the AUDIO_CHUNK PCM, joined, the adapter's int16 of a
    direct ``synthesize`` of the reply. Returns (K1, K3) launches of the
    turn."""
    import threading

    import torch

    from qwen3_asr_swift_tpu_torch.models.qwen3_tts import TTSSamplingConfig
    from qwen3_asr_swift_tpu_torch.models.chat import model as chat
    from qwen3_asr_swift_tpu_torch.pipeline import (PipelineConfig, PipelineEventType,
                                                    VoicePipeline, ensure_library)

    k1c, k3c = counters

    class EnergySilero(type(vad)):
        def __init__(self, inner):
            self.__dict__.update(inner.__dict__)

        def process_chunk(self, state, samples):
            state, _ = super().process_chunk(state, samples)
            return state, (0.9 if np.abs(samples).mean() > 0.05 else 0.05)

    saved = asr.max_tokens, tts.sampling, llm.max_new
    asr.max_tokens = AGENT_STT_TOKENS
    tts.sampling = TTSSamplingConfig(temperature=0.0, top_k=0, max_frames=AGENT_TTS_FRAMES)
    llm.max_new = AGENT_CHAT_TOKENS
    stt = RecordingSTT(asr)
    events, done = [], threading.Event()

    def on_event(ev):
        events.append((time.perf_counter(), ev))
        if ev.type in (PipelineEventType.ERROR,) or (
                ev.type == PipelineEventType.STATE_CHANGED and ev.state.name == "LISTENING"
                and any(e.type == PipelineEventType.RESPONSE_TEXT for _, e in events)):
            done.set()

    audio = agent_audio()
    pipe = None
    try:
        t0 = time.perf_counter()
        engine = ensure_library()
        t_build = time.perf_counter() - t0
        pipe = VoicePipeline(stt=stt, llm=llm, tts=tts, vad=EnergySilero(vad),
                             config=PipelineConfig(eager_stt=False), on_event=on_event)
        k1c.reset()
        k3c.reset()
        with pipe:
            t_push = time.perf_counter()
            pipe.push_audio(audio)
            if not done.wait(AGENT_WAIT_S):
                raise AssertionError(f"agent: no end of turn in {AGENT_WAIT_S} s; saw "
                                     f"{[e.type.name for _, e in events]}")
        torch.cuda.synchronize()
        launches = (k1c.value, k3c.value)
    finally:
        asr.max_tokens, tts.sampling, llm.max_new = saved[0], saved[1], saved[2]
        if pipe is not None:
            pipe.close()
    kinds = [e.type.name for _, e in events if e.type != PipelineEventType.STATE_CHANGED]
    errors = [(e.text, e.aux) for _, e in events if e.type == PipelineEventType.ERROR]
    if errors:
        raise AssertionError(f"agent: ERROR events {errors}")

    def first(kind):
        hit = [(t, e) for t, e in events if e.type == kind]
        if not hit:
            raise AssertionError(f"agent: no {kind.name}; saw {kinds}")
        return hit[0]

    t_end, _ = first(PipelineEventType.SPEECH_ENDED)
    t_final, final = first(PipelineEventType.FINAL_TRANSCRIPT)
    t_reply, reply = first(PipelineEventType.RESPONSE_TEXT)
    t_audio, _ = first(PipelineEventType.AUDIO_CHUNK)
    pcm = np.concatenate([e.pcm for _, e in events if e.type == PipelineEventType.AUDIO_CHUNK])
    if len(stt.audio) != 1:
        raise AssertionError(f"agent: the STT adapter ran {len(stt.audio)} times")
    asr.max_tokens = AGENT_STT_TOKENS
    llm.max_new = AGENT_CHAT_TOKENS
    tts.sampling = TTSSamplingConfig(temperature=0.0, top_k=0, max_frames=AGENT_TTS_FRAMES)
    direct = {}

    def timed(name, fn):
        k1c.reset()
        k3c.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        direct[name] = (time.perf_counter() - t0, k1c.value, k3c.value)
        return out

    try:
        want_text = timed("transcribe", lambda: asr.transcribe(stt.audio[0], sample_rate=SR).text)
        want_reply = timed("chat", lambda: "".join(
            llm.chat([{"role": "user", "content": final.text}])))
        chat_steps = llm.last_loop["steps_run"]
        spoken = timed("synthesize", lambda: tts.synthesize(reply.text))
        tts_frames = tts.last_loop["frames_run"]
    finally:
        asr.max_tokens, tts.sampling, llm.max_new = saved[0], saved[1], saved[2]
    want_pcm = (np.clip(spoken.samples, -1, 1) * 32767.0).astype(np.int16)
    code = (direct["transcribe"][1], chat.packed_products(llm.params) * chat_steps,
            tts_k1_launches(tts.cfg, tts_frames))
    log(f"agent: engine {engine.name} (ready in {t_build:.2f} s); {AGENT_SPEECH_S:g} s of speech "
        f"+ {AGENT_SILENCE_S:g} s of silence pushed in one call; events {kinds[:6]}... "
        f"({len(kinds)}); the STT got {len(stt.audio[0])} samples; transcript "
        f"{final.text[:40]!r} equal to transcribe {final.text == want_text}; reply of "
        f"{len(reply.text)} chars equal to chat {reply.text == want_reply}; {len(pcm)} PCM "
        f"samples in {sum(e.type == PipelineEventType.AUDIO_CHUNK for _, e in events)} chunks, "
        f"equal to synthesize {np.array_equal(pcm, want_pcm)}")
    log(f"agent: end of speech → final transcript {1e3 * (t_final - t_end):.1f} ms, → reply "
        f"text {1e3 * (t_reply - t_end):.1f} ms, → first audio chunk "
        f"{1e3 * (t_audio - t_end):.1f} ms; the direct calls on the main thread: transcribe "
        f"{direct['transcribe'][0]:.3f} s, chat {direct['chat'][0]:.3f} s ({chat_steps} steps), "
        f"synthesize {direct['synthesize'][0]:.3f} s ({tts_frames} frames); K1 launches "
        f"{launches[0]}, from the code {sum(code)} (ASR {code[0]} as its direct call, chat "
        f"{code[1]}, TTS {code[2]}), K3 {launches[1]} (direct {direct['transcribe'][2]}); on "
        f"{dev_name} ({power})")
    if final.text != want_text:
        raise AssertionError(f"agent: transcript {final.text!r} != transcribe {want_text!r}")
    if reply.text != want_reply or not reply.text:
        raise AssertionError(f"agent: reply {reply.text!r} != chat {want_reply!r}")
    if not np.array_equal(pcm, want_pcm):
        raise AssertionError(f"agent: {len(pcm)} PCM samples, synthesize gives {len(want_pcm)}")
    if (launches[0] != sum(code) or launches[1] != direct["transcribe"][2] or code[0] <= 0
            or launches[1] <= 0 or (direct["chat"][1], direct["synthesize"][1]) != code[1:]):
        raise AssertionError(f"agent: K1 {launches[0]} launches (the code {code}), K3 "
                             f"{launches[1]} (direct {direct['transcribe'][2]})")
    return launches


def record_sampler(pp):
    """Wrap ``pp._sample_topk`` to keep each call's fp32 logits and token on
    the device (no host read): returns (the list, a function that undoes
    the wrap)."""
    calls = []
    orig = pp._sample_topk

    def rec(logits, *a, **kw):
        tok = orig(logits, *a, **kw)
        calls.append((logits.float(), tok))
        return tok

    pp._sample_topk = rec
    return calls, lambda: setattr(pp, "_sample_topk", orig)


def first_sampler_parting(got, want, row_got: int = 0, row_want: int = 0):
    """Walk two runs' sampler calls in order: (index of the first call whose
    tokens part or None, ``want``'s margin there between its token and
    ``got``'s, the largest logit gap there, the largest relative L2 of the
    logits before it)."""
    import torch

    worst = 0.0
    for i, ((lg, tg), (lw, tw)) in enumerate(zip(got, want)):
        a, b = lg[row_got], lw[row_want]
        ta, tb = int(tg[row_got]), int(tw[row_want])
        if ta != tb:
            return i, float(b[tb] - b[ta]), float((a - b).abs().max()), worst
        worst = max(worst, (torch.linalg.vector_norm(a - b)
                            / torch.linalg.vector_norm(b)).item())
    return None, 0.0, 0.0, worst


def check_parting(label, parting):
    i, margin, gap, worst = parting
    log(f"duplex {label}: first parting at sampler call "
        f"{'none' if i is None else f'{i} (frame {i // 17})'}; logits before it within rel L2 "
        f"{worst:.3e} (tol {DUPLEX_TOL:g})"
        + ("" if i is None else f"; margin {margin:.4f} against 2 x the largest gap {gap:.4f}"))
    if not worst <= DUPLEX_TOL or (i is not None and not margin <= 2 * gap):
        raise AssertionError(f"duplex {label}: parting {parting}")


def duplex_split(model, user, sampling):
    """4 frames of a session under the profiler, the streaming Mimi encode and
    decode, the temporal step and the depformer in ranges: ({range: device
    ms}, {kernel: µs}, wall s)."""
    from qwen3_asr_swift_tpu_torch.models.personaplex import model as pp

    names = ("mimi_encode_frame", "temporal_step", "depformer_generate", "mimi_decode_frame")
    spf = model.cfg.mimi.samples_per_frame
    s = model.realtime_session(sampling)
    with patch.multiple(pp, **{k: ranged(f"pp.{k}", getattr(pp, k)) for k in names}):
        ms, _, kernels, wall = range_device_ms(
            lambda: [s.push_frame(user[i * spf:(i + 1) * spf])
                     for i in range(DUPLEX_SPLIT_FRAMES)], "pp.")
    return ms, kernels, wall


def phase_duplex(model, k1_counter, dev_name, power):
    """PersonaPlex's full-duplex session over phase respond's 7B (bf16,
    packed 4-bit) and its 4 s of user audio (50 frames), greedy with the
    repetition penalties off (the offline loop's audio window wraps a
    negative start, ROADMAP §3, so with them on the two loops read different
    histories): each frame's streaming Mimi codes equal to the batch
    ``mimi_encode``; the session's agent codes and text tokens equal to the
    card's offline ``_converse`` of the same audio, or parting only at a
    near-tie (every sampler call's logits up to the parting within
    ``DUPLEX_TOL`` relative L2, and there the offline margin within twice
    the largest logit gap), and token for token equal to it at the offline
    loop's cache length; ``batch=2`` with two voice prompts against two
    single sessions under the same rule; an int8-KV session of 50 frames
    and its first parting from the bf16 one; K1's launches 128 + 129 a
    frame; push p50/p90, frames/s, device ms a frame by range, idle share,
    peak memory at batch 1 and 2. Returns K1's launches of the session."""
    import dataclasses

    import torch

    from qwen3_asr_swift_tpu_torch.models.personaplex import PersonaPlex, PersonaSampling
    from qwen3_asr_swift_tpu_torch.models.personaplex import model as pp
    from qwen3_asr_swift_tpu_torch.models.personaplex.mimi import mimi_encode

    cfg = model.cfg
    spf = cfg.mimi.samples_per_frame
    user = respond_user_audio(RESPOND_USER_S)
    n = len(user) // spf
    greedy = PersonaSampling(audio_temperature=0.0, text_temperature=0.0,
                             text_repetition_penalty=1.0, audio_repetition_penalty=1.0,
                             silence_stop_frames=0, max_steps=n)
    with torch.inference_mode():
        batch_codes = mimi_encode(model.mimi_params, cfg.mimi,
                                  torch.as_tensor(user[: n * spf], device=model.device)[None])

    # the offline loop
    off_calls, undo = record_sampler(pp)
    try:
        agent, n_frames, n_done, stats = model._run_converse(user, 24000, greedy, 0.0, None)
    finally:
        undo()

    # the session, timed
    enc_codes = []
    enc_frame = pp.mimi_encode_frame

    def rec_enc(*a, **kw):
        codes, st = enc_frame(*a, **kw)
        enc_codes.append(codes)
        return codes, st

    pp.mimi_encode_frame = rec_enc
    sess_calls, undo = record_sampler(pp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_counter.reset()
    try:
        t0 = time.perf_counter()
        s = model.realtime_session(greedy)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        pushes, codes, texts = [], [], []
        t_run = time.perf_counter()
        for i in range(n):
            t0 = time.perf_counter()
            wav = s.push_frame(user[i * spf:(i + 1) * spf])
            pushes.append(time.perf_counter() - t0)
            codes.append(s.last_codes)
            texts.append(s._text)
            if wav.shape != (spf,) or not np.isfinite(wav).all():
                raise AssertionError(f"duplex: frame {i} gave {wav.shape}")
        wall = time.perf_counter() - t_run
    finally:
        undo()
        pp.mimi_encode_frame = enc_frame
    launches = k1_counter.value
    peak1 = torch.cuda.max_memory_allocated() / 2**30
    want = 4 * cfg.num_layers + n * (4 * cfg.num_layers + 1)
    enc_equal = torch.equal(torch.cat(enc_codes, 2), batch_codes)
    sess = torch.clamp(torch.stack(codes, 2), 0, cfg.mimi.codebook_size - 1)
    same_codes = torch.equal(sess, agent)
    same_text = torch.equal(torch.stack(texts, 1), stats["text_tokens"][:, :n])
    p50, p90 = np.percentile(np.array(pushes) * 1e3, [50, 90])
    log(f"duplex: session of {n} frames (prefill {t_prefill:.3f} s, cache "
        f"{s._cache.valid.shape[1]} slots bf16): push p50 {p50:.1f} ms, p90 {p90:.1f} ms, "
        f"{n / wall:.2f} frames/s against the 12.5 Hz real-time bar; K1 launches {launches}, "
        f"from the code {want}; streaming Mimi codes equal to the batch encode {enc_equal}; "
        f"agent codes equal to the offline loop's {same_codes}, text tokens {same_text}; peak "
        f"device memory {peak1:.2f} GiB (batch 1); on {dev_name} ({power})")
    if not enc_equal:
        raise AssertionError("duplex: streaming Mimi codes differ from the batch encode")
    if launches != want:
        raise AssertionError(f"duplex: K1 launched {launches} times, the code says {want}")
    check_parting("session vs offline", first_sampler_parting(sess_calls, off_calls))

    # the same comparison at the offline loop's cache length: the context cut
    # to the conversation's frames, so both read caches of one shape
    full_cfg = model.cfg
    model.cfg = dataclasses.replace(full_cfg, context=n)
    try:
        short = model.realtime_session(greedy)
    finally:
        model.cfg = full_cfg
    short_codes, short_texts = [], []
    for i in range(n):
        short.push_frame(user[i * spf:(i + 1) * spf])
        short_codes.append(short.last_codes)
        short_texts.append(short._text)
    del short
    short_equal = (torch.equal(torch.clamp(torch.stack(short_codes, 2), 0,
                                           cfg.mimi.codebook_size - 1), agent)
                   and torch.equal(torch.stack(short_texts, 1), stats["text_tokens"][:, :n]))
    log(f"duplex: a session whose cache is the offline loop's length "
        f"({PersonaPlex.VOICE_PROMPT_CAP + PersonaPlex.PROMPT_CAP + n} slots): agent codes and "
        f"text tokens equal to the offline loop's, all {n} frames: {short_equal}")
    if not short_equal:
        raise AssertionError("duplex: at one cache length the session differs from the offline "
                             "loop")

    # batch 2 with two voice prompts against two single sessions
    vps = [model.make_voice_prompt(respond_user_audio(1.0, seed=s_, rate=24000), 24000)
           for s_ in (21, 22)]
    frames = DUPLEX_BATCH_FRAMES
    two = np.stack([user[: frames * spf], respond_user_audio(frames / 12.5, seed=23)[: frames * spf]])
    torch.cuda.reset_peak_memory_stats()
    multi_calls, undo = record_sampler(pp)
    try:
        s2 = model.realtime_session(greedy, batch=2, voice_prompt=vps)
        t0 = time.perf_counter()
        for i in range(frames):
            s2.push_frames(two[:, i * spf:(i + 1) * spf])
        wall2 = time.perf_counter() - t0
    finally:
        undo()
    peak2 = torch.cuda.max_memory_allocated() / 2**30
    del s2
    for row in (0, 1):
        single_calls, undo = record_sampler(pp)
        try:
            s1 = model.realtime_session(greedy, voice_prompt=vps[row])
            for i in range(frames):
                s1.push_frame(two[row, i * spf:(i + 1) * spf])
        finally:
            undo()
        del s1
        check_parting(f"batch 2 row {row} vs single",
                      first_sampler_parting(multi_calls, single_calls, row_got=row))
    log(f"duplex: batch 2 with two voice prompts, {frames} frames in {wall2:.3f} s "
        f"({2 * frames / wall2:.2f} session-frames/s); peak device memory {peak2:.2f} GiB")

    # int8 KV
    s8 = model.realtime_session(greedy, kv_dtype=torch.int8)
    codes8 = []
    t0 = time.perf_counter()
    for i in range(n):
        s8.push_frame(user[i * spf:(i + 1) * spf])
        codes8.append(s8.last_codes)
    wall8 = time.perf_counter() - t0
    diff = [i for i in range(n) if not torch.equal(codes8[i], codes[i])]
    log(f"duplex: int8-KV session, {n} frames in {wall8:.3f} s ({n / wall8:.2f} frames/s); "
        f"first frame whose codes part from the bf16 session's: "
        f"{diff[0] if diff else 'none'} ({len(diff)} of {n} frames differ)")
    del s8

    ranges, kernels, prof_wall = duplex_split(model, user, greedy)
    busy = sum(kernels.values()) / 1e3
    f = DUPLEX_SPLIT_FRAMES
    log(f"duplex under the profiler ({f} frames): wall {prof_wall:.3f} s, device busy "
        f"{busy:.2f} ms (idle {100 * (1 - busy / 1e3 / prof_wall):.1f} %); device ms a frame: "
        f"Mimi encode {ranges.get('mimi_encode_frame', 0.0) / f:.3f}, temporal step "
        f"{ranges.get('temporal_step', 0.0) / f:.3f}, depformer "
        f"{ranges.get('depformer_generate', 0.0) / f:.3f}, Mimi decode "
        f"{ranges.get('mimi_decode_frame', 0.0) / f:.3f}, other (text head, sampling, "
        f"embeddings) {ranges.get('other', 0.0) / f:.3f}; on {dev_name} ({power})")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")
    return launches


PYANNOTE_S = 300         # seconds of 16 kHz audio: 59 windows of 10 s at a 5 s step
PYANNOTE_CHECK_S = 60    # seconds of the card-vs-host check (11 windows)
PYANNOTE_TOL = 1e-4      # speaker activity, of max |host|, card vs host CPU (fp32 both)
PYANNOTE_TIE = 1e-4      # a segment edge may part only at a frame this near onset or offset
FIRERED_S = (60, 150)    # one pass (5,998 rows) and the chunked path (14,998 rows)
FIRERED_TOL = 1e-4       # probabilities, card vs host CPU
FIRERED_CHUNK_TOL = 1e-5  # chunked vs one pass, on the card
WESPEAKER_S = 30         # seconds of the single embedding
WESPEAKER_CLIPS = 40     # clips of 1.5 s in the batch (the 2 s bucket)
CAMPPLUS_S = 8           # seconds of the single CAM++ embedding
CAMPPLUS_CLIPS = 8       # clips of 2-6 s in the CAM++ batch
SPEAKER_TOL = 1e-4       # raw embeddings, relative L2, card vs host CPU
SPEAKER_BATCH_TOL = 1e-5  # batch rows vs embed, relative L2, on the card
DIARIZE_S = 60           # seconds of two synthetic voices
SEPARATE_S = 30          # seconds of 44.1 kHz stereo (1,292 frames)
SEPARATE_CHECK_S = 10    # seconds of the card-vs-host check
SEPARATE_TOL = 1e-4      # each stem, of max |host|, card vs host CPU
TRANSLATE_IDS = 48       # source ids
TRANSLATE_TOKENS = 64    # greedy tokens of the timed run (EOS out of the vocabulary)
TRANSLATE_CHECK_TOKENS = 32  # greedy tokens of the card-vs-host check (real EOS)
TRANSLATE_ENC_TOL = 1e-5  # encoder output, of max |host|, card vs host (2 + 2 layers, fp32)
TRANSLATE_TOL = 1e-4     # each step's logits up to a parting, relative L2, card vs host


def two_voices(seconds: float, rate: int = 16000, seed: int = 11) -> np.ndarray:
    """Two harmonic sources of different F0 (110 and 240 Hz, a slow vibrato
    each) with noise, taking turns of 1.8 s with 0.6 s of near-silence
    between turns."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    turn = (t // 2.4).astype(int)
    speaking = (t % 2.4) < 1.8
    f0 = np.where(turn % 2 == 0, 110.0, 240.0) * (1 + 0.02 * np.sin(2 * np.pi * 3 * t))
    phase = 2 * np.pi * np.cumsum(f0) / rate
    wave = sum(np.sin(k * phase) / k for k in range(1, 7))
    return (0.25 * wave * speaking + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


def profiled(module, ranges, run, prefix):
    """``run()`` once under the profiler with ``module``'s functions
    ``ranges`` ({function: range name}) in profiler ranges: ({range: device
    ms}, device busy ms, wall s)."""
    with patch.multiple(module, **{f: ranged(f"{prefix}{r}", getattr(module, f))
                                   for f, r in ranges.items()}):
        ms, _, kernels, wall = range_device_ms(run, prefix)
    return ms, sum(kernels.values()) / 1e3, wall


def parting_boundaries(card_segs, host_segs, probs, frame_s, onset, offset):
    """Segment edges (s) that the card and the host do not share, and
    whether each lies at a frame whose host probability is within
    ``PYANNOTE_TIE`` of the onset or the offset (a near-tie)."""
    edges = lambda segs: {round(x, 6) for s in segs for x in (s.start, s.end)}
    differ = sorted(edges(card_segs) ^ edges(host_segs))
    near = {round(i * frame_s, 6) for i, p in enumerate(probs)
            if min(abs(p - onset), abs(p - offset)) <= PYANNOTE_TIE}
    return differ, all(d in near for d in differ)


def phase_pyannote(dev, counters, dev_name, power):
    """Pyannote segmentation-3.0 at ``SEGMENTATION_30`` (SincNet 80/60/60,
    4 BiLSTM layers of 128 a direction, 2 linears of 128, 7 powerset
    classes), fp32, random weights drawn on the card (torch seed 0): (a) card
    vs host CPU over ``PYANNOTE_CHECK_S`` s: the speaker activity within
    ``PYANNOTE_TOL`` of max |host|, the VAD's segments equal but where an
    edge sits at a frame within ``PYANNOTE_TIE`` of onset or offset; (b)
    ``detect_speech`` of ``PYANNOTE_S`` s (59 windows in one batched
    forward): windows/s, device ms by range (SincNet, BiLSTM, heads), loop
    iterations, idle share, peak memory; SincNet alone under CUDA events
    beside its range and its bound. K1 and K3 must not run."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.pyannote import (SEGMENTATION_30,
                                                           PyannoteSegmentation, PyannoteVAD)
    from qwen3_asr_swift_tpu_torch.models.pyannote import model as py_mod

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    seg = PyannoteSegmentation.init_random_on_device(SEGMENTATION_30, 0, device=dev)
    audio = two_voices(PYANNOTE_S)
    check = audio[: PYANNOTE_CHECK_S * SR]
    host = PyannoteSegmentation(SEGMENTATION_30, tree_to(seg.params, "cpu"), device="cpu")
    t0 = time.perf_counter()
    want = host.speaker_activity(check)
    host_s = time.perf_counter() - t0
    got = seg.speaker_activity(check)
    err = np.abs(got - want).max() / np.abs(want).max()
    probs = want.max(axis=-1)
    onset = float(np.quantile(probs, 0.6))
    offset = float(np.quantile(probs, 0.4))
    kw = dict(onset=onset, offset=offset)
    card_segs = PyannoteVAD(seg, **kw).detect_speech(check)
    host_segs = PyannoteVAD(host, **kw).detect_speech(check)
    differ, near = parting_boundaries(card_segs, host_segs, probs, seg.frame_duration, onset,
                                      offset)
    log(f"pyannote (a) card vs host CPU, {PYANNOTE_CHECK_S} s ({len(seg.windows(check)[0])} "
        f"windows, host {host_s:.2f} s): activity max err {err:.3e} of max |host| (tol "
        f"{PYANNOTE_TOL:g}); {len(card_segs)} / {len(host_segs)} segments at onset {onset:.4f}, "
        f"offset {offset:.4f}; edges parting {differ} (near-ties: {near})")
    if not (got.shape == want.shape and err <= PYANNOTE_TOL and near):
        raise AssertionError(f"pyannote card vs host: activity {err}, edges {differ}")
    del host

    vad = PyannoteVAD(seg)
    vad.detect_speech(check)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    segs = vad.detect_speech(audio)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loop = dict(seg.last_loop)
    ranges, busy, prof_wall = profiled(
        py_mod, {"sincnet": "sincnet", "bilstm": "bilstm", "segmentation_forward": "heads"},
        lambda: seg.window_speakers(seg.windows(audio)[1]), "pyannote.")
    log(f"pyannote (b) SEGMENTATION_30, {PYANNOTE_S} s: detect_speech {wall:.3f} s = "
        f"{loop['windows'] / wall:.1f} windows/s ({loop['windows']} windows of "
        f"{loop['frames']} frames), {len(segs)} segments; loop {loop['iterations']} iterations "
        f"(both directions and every window in one); peak memory {peak:.2f} GiB; on {dev_name} "
        f"({power})")
    log(f"pyannote forward under the profiler: wall {prof_wall:.3f} s, device busy {busy:.2f} ms "
        f"(idle {100 * (1 - busy / 1e3 / prof_wall):.1f} %); device ms: SincNet "
        f"{ranges.get('sincnet', 0.0):.3f}, BiLSTM {ranges.get('bilstm', 0.0):.3f}, heads "
        f"{ranges.get('heads', 0.0):.3f}, other {ranges.get('other', 0.0):.3f}; on {dev_name} "
        f"({power})")
    wave = torch.from_numpy(seg.windows(audio)[1]).to(dev)
    k0, c0 = seg.cfg.sincnet_kernels[0], seg.cfg.sincnet_filters[0]   # the first conv leads
    out0 = (wave.shape[1] - k0) // seg.cfg.sincnet_strides[0] + 1
    log("pyannote: " + stage_check(
        "SincNet", ranges.get("sincnet", 0.0), lambda: py_mod.sincnet(seg.params, seg.cfg, wave),
        4 * (wave.numel() + c0 * k0), 2 * wave.shape[0] * out0 * c0 * k0))
    del wave
    if loop["windows"] != len(seg.windows(audio)[0]) or not all(s.end > s.start for s in segs):
        raise AssertionError(f"pyannote: {loop} windows, segments {segs[:3]}")
    check_counters_still("pyannote", counters, before)
    log(f"pyannote: phase {time.perf_counter() - t_phase:.1f} s")


def phase_firered(dev, counters, dev_name, power):
    """FireRedVAD at ``CONFIG_FIRERED`` (80 mels, LFR 5, 4 FSMN blocks of 20
    causal taps), fp32, drawn on the card: 60 s (one pass, fused
    fbank-LFR-FSMN) and 150 s (15,000 frames: the chunked path, 6,000-row
    chunks overlapping by the receptive field); card vs host CPU
    probabilities within ``FIRERED_TOL``, the chunked path on the card within
    ``FIRERED_CHUNK_TOL`` of one pass; ms a second of audio by path."""
    import dataclasses

    import torch

    from qwen3_asr_swift_tpu_torch.models.firered_vad import CONFIG_FIRERED, FireRedVAD

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    card = FireRedVAD.init_random_on_device(CONFIG_FIRERED, 0, device=dev)
    host = FireRedVAD(CONFIG_FIRERED, tree_to(card.params, "cpu"), device="cpu")
    one = FireRedVAD(dataclasses.replace(CONFIG_FIRERED, max_frames=10 ** 6), card.params,
                     device=dev)
    audio = two_voices(max(FIRERED_S), seed=12)
    card.frame_probabilities(audio[:SR])
    lines = []
    for seconds in FIRERED_S:
        clip = audio[: seconds * SR]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card.frame_probabilities(clip)
        wall = time.perf_counter() - t0
        path = card.last_path
        err = np.abs(got - host.frame_probabilities(clip)).max()
        single = one.frame_probabilities(clip)
        chunk_err = np.abs(got - single).max()
        segs = card.detect_speech(clip)
        lines.append(f"{seconds} s: path {path[0]} ({path[1]} chunk(s), {len(got)} rows) "
                     f"{1e3 * wall / seconds:.3f} ms a second of audio; card vs host {err:.3e} "
                     f"(tol {FIRERED_TOL:g}); vs one pass ({one.last_path[0]}) {chunk_err:.3e} "
                     f"(tol {FIRERED_CHUNK_TOL:g}); {len(segs)} segments")
        if not (err <= FIRERED_TOL and chunk_err <= FIRERED_CHUNK_TOL and np.isfinite(got).all()):
            raise AssertionError(f"firered {seconds} s: card vs host {err}, chunked {chunk_err}")
    if [ln.split("path ")[1].split(" ")[0] for ln in lines] != ["single", "chunked"]:
        raise AssertionError(f"firered paths: {lines}")
    log(f"firered CONFIG_FIRERED: " + "; ".join(lines) + f"; on {dev_name} ({power})")
    check_counters_still("firered", counters, before)
    log(f"firered: phase {time.perf_counter() - t_phase:.1f} s")


def phase_speaker(dev, counters, dev_name, power):
    """WeSpeaker ResNet34 at the published widths (32/64/128/256, blocks
    3/4/6/3) and CAM++ at ``CONFIG_CAMPPLUS`` (192-d, blocks 12/24/16),
    fp32, drawn on the card: ``embed`` of ``WESPEAKER_S`` s and
    ``embed_batch`` of ``WESPEAKER_CLIPS`` clips of 1.5 s; CAM++ ``embed`` of
    ``CAMPPLUS_S`` s and ``embed_batch`` of ``CAMPPLUS_CLIPS`` clips. Card vs
    host CPU raw embeddings within ``SPEAKER_TOL`` relative L2, batch rows vs
    ``embed`` on the card within ``SPEAKER_BATCH_TOL``; then ``clone_voice``
    on a CosyVoice ``CONFIG_05B`` cut to 2 + 2 layers with the card's CAM++:
    the stored vector equal to CAM++'s ``embed``. ms an embedding, single
    and batched; peak memory."""
    import dataclasses

    import torch

    from qwen3_asr_swift_tpu_torch.models.cosyvoice import CONFIG_05B, CosyVoiceTTS
    from qwen3_asr_swift_tpu_torch.models.speaker import CampPlusSpeaker, WeSpeaker
    from qwen3_asr_swift_tpu_torch.models.speaker.campplus import CONFIG_CAMPPLUS

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    voices = two_voices(60, seed=13)
    rng = np.random.default_rng(14)

    def timed_call(fn, *a):
        fn(*a)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30

    # WeSpeaker
    wes = WeSpeaker.init_random_on_device(0, device=dev)
    host = WeSpeaker(tree_to(wes.params, "cpu"), device="cpu")
    clip = voices[: WESPEAKER_S * SR]
    stage = np.zeros((1, wes.bucket_samples(len(clip))), np.float32)
    stage[0, : len(clip)] = clip
    n = np.asarray([len(clip)])
    single, s_wall, s_peak = timed_call(wes.embed_raw, stage, n)
    rel = rel_l2(single, host.embed_raw(stage, n))
    starts = rng.integers(0, len(voices) - 24000, WESPEAKER_CLIPS)
    clips = [voices[s: s + 24000] for s in starts]
    batch, b_wall, b_peak = timed_call(wes.embed_batch, clips)
    rows = max(rel_l2(batch[i], wes.embed(c)) for i, c in enumerate(clips[:8]))
    stage_b = np.stack([np.pad(c, (0, 32000 - len(c))) for c in clips[:8]])
    n_b = np.full(len(stage_b), 24000)
    rel_b = rel_l2(wes.embed_raw(stage_b, n_b), host.embed_raw(stage_b, n_b))
    log(f"speaker: WeSpeaker (published widths, {wes.embed_dim}-d) embed of {WESPEAKER_S} s "
        f"{1e3 * s_wall:.2f} ms (peak {s_peak:.2f} GiB); embed_batch of {WESPEAKER_CLIPS} x 1.5 s "
        f"{1e3 * b_wall:.2f} ms = {1e3 * b_wall / WESPEAKER_CLIPS:.3f} ms an embedding (peak "
        f"{b_peak:.2f} GiB); card vs host raw rel L2 {rel:.3e} single, {rel_b:.3e} on 8 batch "
        f"rows (tol {SPEAKER_TOL:g}); batch rows vs embed {rows:.3e} (tol "
        f"{SPEAKER_BATCH_TOL:g}); on {dev_name} ({power})")
    if not (rel <= SPEAKER_TOL and rel_b <= SPEAKER_TOL and rows <= SPEAKER_BATCH_TOL):
        raise AssertionError(f"wespeaker: card vs host {rel} / {rel_b}, rows vs embed {rows}")
    del host

    # CAM++
    cam = CampPlusSpeaker.init_random_on_device(CONFIG_CAMPPLUS, 0, device=dev)
    host = CampPlusSpeaker(CONFIG_CAMPPLUS, tree_to(cam.params, "cpu"), device="cpu")
    clip = voices[: CAMPPLUS_S * SR]
    single, s_wall, s_peak = timed_call(cam.embed, clip)
    rel = rel_l2(single, host.embed(clip))
    lengths = rng.integers(2 * SR, 6 * SR, CAMPPLUS_CLIPS)
    clips = [voices[i * SR: i * SR + n] for i, n in enumerate(lengths)]
    batch, b_wall, b_peak = timed_call(cam.embed_batch, clips)
    rows = max(rel_l2(batch[i], cam.embed(c)) for i, c in enumerate(clips))
    rel_b = rel_l2(batch, host.embed_batch(clips))
    log(f"speaker: CAM++ CONFIG_CAMPPLUS ({cam.embedding_dim}-d) embed of {CAMPPLUS_S} s "
        f"{1e3 * s_wall:.2f} ms (peak {s_peak:.2f} GiB); embed_batch of {CAMPPLUS_CLIPS} clips of "
        f"2-6 s {1e3 * b_wall:.2f} ms = {1e3 * b_wall / CAMPPLUS_CLIPS:.3f} ms an embedding "
        f"(peak {b_peak:.2f} GiB); card vs host rel L2 {rel:.3e} single, {rel_b:.3e} batch (tol "
        f"{SPEAKER_TOL:g}); batch rows vs embed {rows:.3e} (tol {SPEAKER_BATCH_TOL:g}); on "
        f"{dev_name} ({power})")
    if not (rel <= SPEAKER_TOL and rel_b <= SPEAKER_TOL and rows <= SPEAKER_BATCH_TOL):
        raise AssertionError(f"campplus: card vs host {rel} / {rel_b}, rows vs embed {rows}")
    del host

    # clone_voice with the card's CAM++
    cut = dataclasses.replace(CONFIG_05B, num_layers=2, flow=dataclasses.replace(
        CONFIG_05B.flow, dit=dataclasses.replace(CONFIG_05B.flow.dit, depth=2)))
    tts = CosyVoiceTTS.init_random_on_device(cut, 0, device=dev)
    ref = voices[3 * SR: 9 * SR]
    tts.clone_voice("cloned", ref, SR, speaker_model=cam)
    stored = tts.voices["cloned"].embedding
    want = cam.embed(ref)[: cut.flow.spk_embed_dim]
    log(f"speaker: clone_voice on CosyVoice CONFIG_05B (2 + 2 layers) with the card's CAM++: "
        f"stored vector of {len(stored)} equal to embed: {bool(np.array_equal(stored, want))}")
    if not np.array_equal(stored, want):
        raise AssertionError("clone_voice stored another vector than CAM++'s embed")
    del tts
    check_counters_still("speaker", counters, before)
    log(f"speaker: phase {time.perf_counter() - t_phase:.1f} s")
    return wes


class EnergySilero:
    """A Silero VAD whose random probabilities (its chunk program runs on
    the card) have an energy decision laid over them, a 512-sample chunk
    at a time, as phase agent does: what the pipeline's windows need is
    speech where the synthetic voices speak."""

    def __init__(self, vad):
        self.vad = vad

    def detect_speech(self, audio, sample_rate=SR):
        from qwen3_asr_swift_tpu_torch.models.silero_vad import VADConfig, binarize

        probs = self.vad.speech_probabilities(audio, sample_rate)
        n = len(probs)
        energy = np.abs(np.pad(audio, (0, n * 512 - len(audio)))).reshape(n, 512).mean(1)
        return binarize(np.where(energy > 0.05, 0.9, 0.05).astype(np.float32), VADConfig())


def phase_diarize(wes, dev, counters, dev_name, power):
    """``DiarizationPipeline(SileroVAD, WeSpeaker)`` on the card over
    ``DIARIZE_S`` s of two synthetic voices: the random Silero runs with an
    energy decision laid over it (:class:`EnergySilero`), WeSpeaker is phase
    speaker's. At least 20 windows; the labels from the card's embeddings
    equal those from the host's embeddings of the same windows, unless a
    merge distance of the linkage lies within 1e-4 of the threshold. Wall,
    windows, ms a window, segments."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.diarization import (DiarizationPipeline,
                                                              agglomerative_cluster)
    from qwen3_asr_swift_tpu_torch.models.silero_vad import SileroVAD
    from qwen3_asr_swift_tpu_torch.models.speaker import WeSpeaker

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    audio = two_voices(DIARIZE_S, seed=15)
    seen = []
    embed_batch = wes.embed_batch

    def recording(clips, sr=SR):
        out = embed_batch(clips, sr)
        seen.append((list(clips), out))
        return out

    pipe = DiarizationPipeline(EnergySilero(SileroVAD.init_random(0, device=dev)), wes)
    pipe.diarize(audio[: 10 * SR])
    with patch.object(wes, "embed_batch", recording):
        seen.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segs = pipe.diarize(audio, num_speakers=None)
        wall = time.perf_counter() - t0
        labels2 = [s.speaker for s in pipe.diarize(audio, num_speakers=2)]
    clips, card = seen[0]
    host = WeSpeaker(tree_to(wes.params, "cpu"), device="cpu").embed_batch(clips)
    thr = pipe.cfg.cluster_threshold
    got = agglomerative_cluster(card, thr, None, pipe.cfg.max_speakers)
    want = agglomerative_cluster(host, thr, None, pipe.cfg.max_speakers)
    got2 = agglomerative_cluster(card, thr, 2)
    want2 = agglomerative_cluster(host, thr, 2)
    from scipy.cluster.hierarchy import linkage
    from scipy.spatial.distance import squareform

    dist = np.clip(1.0 - card @ card.T, 0.0, None)
    np.fill_diagonal(dist, 0.0)
    margin = float(np.abs(linkage(squareform(dist, checks=False), "average")[:, 2] - thr).min())
    log(f"diarize: {DIARIZE_S} s of two voices, {len(clips)} windows: wall {wall:.3f} s = "
        f"{1e3 * wall / len(clips):.2f} ms a window; {len(segs)} segments, "
        f"{len(set(got.tolist()))} speaker(s) at the threshold, {len(set(labels2))} with "
        f"num_speakers=2; card vs host embeddings rel L2 {rel_l2(card, host):.3e}; labels equal "
        f"{bool((got == want).all())} (threshold) / {bool((got2 == want2).all())} (2 speakers); "
        f"nearest merge distance to the threshold {margin:.3e}; on {dev_name} ({power})")
    if len(clips) < 20 or not segs:
        raise AssertionError(f"diarize: {len(clips)} windows, {len(segs)} segments")
    if not ((got == want).all() or margin <= 1e-4) or not (got2 == want2).all():
        raise AssertionError(f"diarize: labels card {got.tolist()} host {want.tolist()}")
    check_counters_still("diarize", counters, before)
    log(f"diarize: phase {time.perf_counter() - t_phase:.1f} s")


def music(seconds: float, rate: int = 44100, seed: int = 16) -> np.ndarray:
    """Stereo: a bass line, a vibrato lead and noise hits, panned apart."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    bass = 0.3 * np.sin(2 * np.pi * 55 * t * (1 + (t % 2 > 1)))
    lead = 0.2 * np.sin(2 * np.pi * 440 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
    hits = 0.1 * rng.standard_normal(len(t)) * ((t * 4) % 1 < 0.1)
    return np.stack([bass + 0.7 * lead + hits, bass + 0.3 * lead + hits]).astype(np.float32)


def phase_separate(dev, counters, dev_name, power):
    """Open-Unmix at ``init_umx_params``' defaults (1,487 bins, hidden 512,
    stereo), 4 stems, fp32, drawn on the card: card vs host CPU on
    ``SEPARATE_CHECK_S`` s, each stem within ``SEPARATE_TOL`` of max |host|;
    ``separate`` of ``SEPARATE_S`` s at 44.1 kHz (1,292 frames): RTF, device
    ms by range (STFT, fc, BiLSTM, Wiener, iSTFT), loop iterations, idle
    share, peak memory; the STFT alone under CUDA events beside its range
    and its bound."""
    import torch

    from qwen3_asr_swift_tpu_torch.models.separation import SourceSeparator
    from qwen3_asr_swift_tpu_torch.models.separation import model as sep_mod

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    card = SourceSeparator.init_random_on_device(0, device=dev)
    host = SourceSeparator({s: tree_to(p, "cpu") for s, p in card.stem_params.items()},
                           device="cpu")
    audio = music(SEPARATE_S)
    check = audio[:, : SEPARATE_CHECK_S * 44100]
    got, want = card.separate(check, 44100), host.separate(check, 44100)
    errs = {s: float(np.abs(got[s] - want[s]).max() / np.abs(want[s]).max()) for s in want}
    log(f"separate (a) card vs host CPU, {SEPARATE_CHECK_S} s: " + ", ".join(
        f"{s} {e:.3e}" for s, e in errs.items()) + f" of max |host| (tol {SEPARATE_TOL:g})")
    if not all(e <= SEPARATE_TOL for e in errs.values()):
        raise AssertionError(f"separate card vs host: {errs}")
    del host
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = card.separate(audio, 44100)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loop = dict(card.last_loop)
    ranges, busy, prof_wall = profiled(
        sep_mod, {"stft": "stft", "umx_forward_stems": "fc", "bilstm_stems": "bilstm",
                  "wiener_masks": "wiener", "istft": "istft"},
        lambda: card.separate(audio, 44100), "separate.")
    log(f"separate (b) 4 stems, {SEPARATE_S} s stereo at 44.1 kHz ({loop['frames']} frames): "
        f"{wall:.3f} s, RTF {wall / SEPARATE_S:.4f}; loop {loop['iterations']} iterations (4 "
        f"stems x 2 directions in each); peak memory {peak:.2f} GiB; on {dev_name} ({power})")
    log(f"separate under the profiler: wall {prof_wall:.3f} s, device busy {busy:.2f} ms (idle "
        f"{100 * (1 - busy / 1e3 / prof_wall):.1f} %); device ms: STFT "
        f"{ranges.get('stft', 0.0):.3f}, fc {ranges.get('fc', 0.0):.3f}, BiLSTM "
        f"{ranges.get('bilstm', 0.0):.3f}, Wiener {ranges.get('wiener', 0.0):.3f}, iSTFT "
        f"{ranges.get('istft', 0.0):.3f}, other {ranges.get('other', 0.0):.3f}; on {dev_name} "
        f"({power})")
    x = torch.from_numpy(audio).to(dev)
    frames, bins = audio.shape[1] // sep_mod.HOP + 1, sep_mod.N_FFT // 2 + 1
    log("separate: " + stage_check(
        "STFT", ranges.get("stft", 0.0), lambda: sep_mod.stft(x, frames),
        4 * (x.numel() + 2 * sep_mod.N_FFT * bins + 2 * len(audio) * frames * bins),
        2 * 2 * len(audio) * frames * sep_mod.N_FFT * bins))
    del x
    if sorted(out) != sorted(card.stem_params) or not all(
            o.shape == audio.shape and np.isfinite(o).all() for o in out.values()):
        raise AssertionError(f"separate: {[(s, o.shape) for s, o in out.items()]}")
    check_counters_still("separate", counters, before)
    log(f"separate: phase {time.perf_counter() - t_phase:.1f} s")


def phase_translate(dev, counters, dev_name, power):
    """MADLAD-400 ``CONFIG_3B`` (vocab 256,000, d_model 1024, 16 x 128 heads,
    d_ff 8192, 32 + 32 layers): (a) at its widths cut to 2 + 2 layers, fp32,
    real EOS, drawn on the card: card vs host CPU encoder output within
    ``TRANSLATE_ENC_TOL`` of max |host|, the first step's logits within
    ``TRANSLATE_TOL`` relative L2, ``TRANSLATE_CHECK_TOKENS`` greedy ids equal
    or parting at a near-tie; (b) the 3B in bf16 (as ``from_pretrained``
    loads it) drawn on the card, a ``TRANSLATE_IDS``-id source,
    ``TRANSLATE_TOKENS`` greedy tokens with EOS set outside the vocabulary
    for this run only: tokens/s, encoder ms, device ms a token, idle share,
    peak memory."""
    import dataclasses

    import torch

    from qwen3_asr_swift_tpu_torch.core.params import tree_tensors
    from qwen3_asr_swift_tpu_torch.models.translation import CONFIG_3B, MADLADTranslator
    from qwen3_asr_swift_tpu_torch.models.translation import model as t5

    before = [c.value for c in counters]
    t_phase = time.perf_counter()
    ids = np.random.default_rng(17).integers(3, CONFIG_3B.vocab_size, TRANSLATE_IDS).tolist()
    ids[-1] = CONFIG_3B.eos_token_id

    # (a) card vs host at 2 + 2 layers, fp32
    cut = dataclasses.replace(CONFIG_3B, num_encoder_layers=2, num_decoder_layers=2)
    t0 = time.perf_counter()
    card = MADLADTranslator.init_random_on_device(cut, 0, device=dev)
    host = MADLADTranslator(cut, tree_to(card.params, "cpu"), device="cpu")
    runs = {}
    with torch.inference_mode():
        for where, m in (("card", card), ("host", host)):
            arr, valid = m.prepare(ids)
            enc = t5.t5_encode(m.params, cut, arr, valid).float().cpu()
            logits = []
            out, steps, _ = t5.greedy_translate(
                m.params, cut, arr, valid, TRANSLATE_CHECK_TOKENS,
                on_step=lambda step, lg: logits.append(lg[0].float().cpu()))
            runs[where] = (enc, out[0, :steps].tolist(), logits)
    enc_err = (runs["card"][0] - runs["host"][0]).abs().max().item() / \
        runs["host"][0].abs().max().item()
    log(f"translate (a) CONFIG_3B widths at 2 + 2 layers, fp32: encoder card vs host "
        f"{enc_err:.3e} of max |host| (tol {TRANSLATE_ENC_TOL:g}); {len(runs['card'][1])} / "
        f"{len(runs['host'][1])} steps; {time.perf_counter() - t0:.1f} s with the host's share")
    if not enc_err <= TRANSLATE_ENC_TOL:
        raise AssertionError(f"translate encoder card vs host {enc_err}")
    first = rel_l2(runs["card"][2][0], runs["host"][2][0])
    if not first <= TRANSLATE_TOL:
        raise AssertionError(f"translate first-step logits rel L2 {first}")
    token_parting("translate (a)", runs["card"][1], runs["host"][1], runs["card"][2],
                  runs["host"][2], tol=TRANSLATE_TOL)
    del card, host, runs

    # (b) the 3B in bf16, timed
    t0 = time.perf_counter()
    model = MADLADTranslator.init_random_on_device(CONFIG_3B, 0, device=dev,
                                                   dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_tensors(model.params))
    log(f"translate weights: CONFIG_3B ({n_params / 1e9:.3f} G parameters, bf16) drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    model.cfg = dataclasses.replace(CONFIG_3B, eos_token_id=CONFIG_3B.vocab_size)
    model.translate_ids(ids[:16], max_new=8)
    arr, valid = model.prepare(ids)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t5.t5_encode(model.params, model.cfg, arr, valid)
        torch.cuda.synchronize()
        enc_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    out = model.translate_ids(ids, max_new=TRANSLATE_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms, _, kernels, prof_wall = range_device_ms(
        lambda: model.translate_ids(ids, max_new=TRANSLATE_TOKENS), "translate.")
    busy = sum(kernels.values()) / 1e3
    log(f"translate (b) CONFIG_3B bf16, {TRANSLATE_IDS} ids -> {len(out)} tokens: {wall:.3f} s = "
        f"{len(out) / wall:.2f} tokens/s (encoder {enc_ms:.2f} ms); loop {model.last_loop}; "
        f"peak memory {peak:.2f} GiB ({resident:.2f} resident); on {dev_name} ({power})")
    log(f"translate under the profiler: wall {prof_wall:.3f} s, device busy {busy:.2f} ms = "
        f"{busy / TRANSLATE_TOKENS:.3f} ms a token with the encoder (idle "
        f"{100 * (1 - busy / 1e3 / prof_wall):.1f} %); on {dev_name} ({power})")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:4]:
        log(f"  device {us / 1e3:9.2f} ms  {name[:100]}")
    if len(out) != TRANSLATE_TOKENS or model.last_loop["steps"] != TRANSLATE_TOKENS:
        raise AssertionError(f"translate: {len(out)} tokens, loop {model.last_loop}")
    del model
    check_counters_still("translate", counters, before)
    log(f"translate: phase {time.perf_counter() - t_phase:.1f} s")


def phase_cli(dev_name):
    """``python -m qwen3_asr_swift_tpu_torch.cli`` on the card (its default
    device) with ``--random-weights``: transcribe, transcribe-batch, align,
    vad (each engine: silero, pyannote, firered), vad-stream, diarize,
    embed-speaker (WeSpeaker and CAM++), speak, denoise, separate,
    translate, respond, vibevoice, kokoro and voxcpm2, one process each, all
    started together; each must exit 0 and print the reference's JSON keys
    (vad-stream: its event lines), and ``diarize --engine sortformer`` must
    exit non-zero naming the roadmap. Prints each subcommand's wall."""
    import tempfile

    from qwen3_asr_swift_tpu_torch.audio.io import write_wav

    keys = {"transcribe": {"text", "confidence", "duration", "rtf"},
            "transcribe-batch": {"file", "text", "confidence"},
            "align": {"word", "start", "end"}, "vad": {"start", "end"},
            "diarize": {"start", "end", "speaker"},
            "embed-speaker": {"dim", "norm", "embedding"},
            "speak": {"output", "seconds"}, "denoise": {"output"},
            "separate": {"vocals", "drums", "bass", "other"}, "translate": {"note", "ids"},
            "respond": {"output", "seconds"}, "vibevoice": {"output", "seconds"},
            "kokoro": {"output", "seconds", "voices"}, "voxcpm2": {"output", "seconds"}}
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(4)
        t = np.arange(3 * 16000) / 16000
        clip = os.path.join(d, "clip.wav")
        write_wav(clip, (0.3 * np.sin(2 * np.pi * 220 * t) * (t > 1)
                         + 0.01 * rng.standard_normal(len(t))).astype(np.float32), 16000)
        runs = {"transcribe": ["transcribe", clip, "--max-tokens", "8"],
                "transcribe-batch": ["transcribe-batch", clip, clip, "--max-tokens", "8"],
                "align": ["align", clip, "hello big world"], "vad": ["vad", clip],
                "vad pyannote": ["vad", clip, "--engine", "pyannote"],
                "vad firered": ["vad", clip, "--engine", "firered"],
                "vad-stream": ["vad-stream", clip], "diarize": ["diarize", clip],
                "diarize sortformer": ["diarize", clip, "--engine", "sortformer"],
                "embed-speaker": ["embed-speaker", clip],
                "embed-speaker campplus": ["embed-speaker", clip, "--model", "campplus"],
                "speak": ["speak", "hello", "--output", os.path.join(d, "out.wav")],
                "denoise": ["denoise", clip, "--output", os.path.join(d, "denoised.wav")],
                "separate": ["separate", clip, "--output-prefix", os.path.join(d, "stem")],
                "translate": ["translate", "hello"],
                "respond": ["respond", clip, "--output", os.path.join(d, "response.wav")],
                "vibevoice": ["vibevoice", "hello", "--output", os.path.join(d, "vibevoice.wav")],
                "kokoro": ["kokoro", "hello", "--output", os.path.join(d, "kokoro.wav")],
                "voxcpm2": ["voxcpm2", "hello", "--output", os.path.join(d, "voxcpm2.wav")]}
        t0 = time.perf_counter()
        procs, walls = {}, {}
        for name, args in runs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "qwen3_asr_swift_tpu_torch.cli", args[0],
                 "--random-weights", *args[1:]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        outs = {}
        try:
            for name, p in procs.items():
                outs[name] = p.communicate(timeout=300)
                walls[name] = time.perf_counter() - t0
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for name, p in procs.items():
            out, err = outs[name]
            if name == "diarize sortformer":
                if p.returncode == 0 or "ROADMAP" not in err:
                    raise AssertionError(f"cli {name}: exit {p.returncode}: {err[-500:]}")
                log(f"cli {name}: exit {p.returncode}, {err.strip().splitlines()[-1][:160]!r}")
                continue
            if p.returncode != 0:
                raise AssertionError(f"cli {name}: exit {p.returncode}: {err[-2000:]}")
            # the CLI prints its own wall on stderr as "[N.Ns]"
            own = err.strip().splitlines()[-1] if err.strip() else "?"
            if name == "vad-stream":
                got = {line.split()[-1] for line in out.splitlines()}
                if not got <= {"speech_started", "speech_ended"}:
                    raise AssertionError(f"cli vad-stream printed {out[:500]}")
                log(f"cli {name}: exit 0, {len(out.splitlines())} event lines, {own}")
                continue
            obj = json.loads(out)
            items = obj if isinstance(obj, list) else [obj]
            want = keys[name.split()[0]]
            if any(set(i) != want for i in items) or (
                    name.split()[0] not in ("vad", "diarize") and not items):
                raise AssertionError(f"cli {name}: keys {[sorted(i) for i in items]}")
            log(f"cli {name}: exit 0, keys {sorted(want)}, {own} in the process, "
                f"{walls[name]:.1f} s to its exit: {out.strip()[:120]!r}")
        log(f"cli: {len(procs)} runs on {dev_name} in {wall:.1f} s (in parallel)")


def main() -> int:
    import dataclasses

    import torch

    t_start = time.perf_counter()
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

    t_run = time.perf_counter()

    def mark(name):
        log(f"phase {name} done, {time.perf_counter() - t_run:.1f} s into the run")

    k1, k2, k3 = phase_k1(dev), phase_k2(dev), phase_k3(dev)
    mark("k1-k3")
    weights, host_weights = make_weights(dev)
    phase_step(host_weights)
    model = build_model(*weights, "cuda", torch.bfloat16)
    del weights
    phase_codec(model, dev_name, power)
    launches, _ = phase_slice(model, (K1_LAUNCHES, K3_LAUNCHES, WIRE_NATIVE_CALLS), dev_name,
                              power)
    k1["launches"] = launches["quant_matmul_cuda"]
    k3["launches"] = launches["decode_attention_int8"]
    mark("slice")
    k2["launches"] = phase_pool(model, (K1_LAUNCHES, K2_LAUNCHES), dev_name,
                                power)["quant_matmul_plane_cuda"]
    phase_beam_sampling(model, (K1_LAUNCHES, K3_LAUNCHES))
    phase_serve(model)
    mark("pool, beam, serve")
    phase_load(host_weights, dev_name, power)
    phase_groupdot(host_weights, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    del host_weights
    vad, stream = phase_vad(dev_name, power)
    phase_stream(model, vad, stream, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    phase_align(dev, dev_name, power)
    mark("load, groupdot, vad, stream, align")
    tts, k1["launches_tts"], k1["tts_frame"] = phase_tts(dev, K1_LAUNCHES, dev_name, power)
    mark("tts")
    phase_speak(model, tts, dev_name, power)
    mark("speak")
    cosy = phase_cosyvoice(dev, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    mark("cosyvoice")
    vibe = phase_vibevoice(dev, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    mark("vibevoice")
    kokoro = phase_kokoro(dev, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    mark("kokoro")
    vox = phase_voxcpm2(dev, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    vox.cfg = dataclasses.replace(vox.cfg, max_tokens=SPEAK_VOX_TOKENS)
    mark("voxcpm2")
    phase_speak_engines(model, {"cosyvoice": cosy, "vibevoice": vibe, "kokoro": kokoro,
                                "voxcpm2": vox}, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    del cosy, vibe, kokoro, vox
    mark("speak (engines)")
    phase_realtime(model, tts, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    mark("realtime")
    chat, k1["launches_chat"], k1["chat_token"] = phase_chat(dev, K1_LAUNCHES, dev_name, power)
    mark("chat")
    k1["launches_agent"], k3["launches_agent"] = phase_agent(
        model, vad, chat, tts, (K1_LAUNCHES, K3_LAUNCHES), dev_name, power)
    del tts, chat
    mark("agent")
    phase_enhance(dev_name, power)
    mark("enhance")
    k1["launches_respond"], k1["respond_frame"], s2s = phase_respond(dev, K1_LAUNCHES, dev_name,
                                                                     power)
    mark("respond")
    k1["launches_duplex"] = phase_duplex(s2s, K1_LAUNCHES, dev_name, power)
    del s2s
    mark("duplex")
    counters = (K1_LAUNCHES, K3_LAUNCHES)
    phase_pyannote(dev, counters, dev_name, power)
    mark("pyannote")
    phase_firered(dev, counters, dev_name, power)
    mark("firered")
    wes = phase_speaker(dev, counters, dev_name, power)
    mark("speaker")
    phase_diarize(wes, dev, counters, dev_name, power)
    del wes
    mark("diarize")
    phase_separate(dev, counters, dev_name, power)
    mark("separate")
    phase_translate(dev, counters, dev_name, power)
    mark("translate")
    phase_cli(dev_name)
    mark("cli")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    ref = [m for m in sys.modules if m == "qwen3_asr_swift_tpu" or m.startswith("qwen3_asr_swift_tpu.")]
    if ref:
        raise AssertionError(f"the JAX package was imported: {ref}")

    log(f"whole run: {time.perf_counter() - t_start:.1f} s, the build included")
    log(json.dumps({"kernels": [k1, k2, k3]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
