"""Token-level continuous batching: a slot-pool KV decoder for Qwen3-ASR —
port of ``qwen3_asr_swift_tpu/serving/slotpool.py``.

The pool is a FIXED ``[slots, max_len]`` KV arena on the device:

- every live slot decodes in ONE shared tick of ``tick_tokens`` steps (the
  weights are read once per step for the whole pool; with a packed
  decoder every product of the tick goes through kernel K1 or K2), with
  per-slot cursors, positions and budgets, and no host sync until the
  tick's end;
- requests are admitted into free slots at tick boundaries. Encode and
  prefill run on an admission thread, batched when several requests of
  one audio bucket and prompt wait, and hand prompt-sized segments to the
  tick thread, which copies them into the arena (one indexed write per
  layer);
- a slot that hits EOS or its budget goes dormant (masked) until reused;
  retirement is host bookkeeping.

Threads: callers ``submit``; the ADMIT worker prestages, encodes and
prefills (latency-class arrivals first, groups sized to powers of two by
the credits actually acquired; a semaphore of ``slots`` credits bounds
live slots plus prepared segments); the TICK thread owns the arena. Both
workers enter ``torch.inference_mode`` themselves (it is thread-local),
draw from their own ``torch.Generator`` (tick seeded 0, admission 1, as
the reference's two keys), and use the same CUDA stream, so a segment is
complete, in stream order, before the tick that inserts it. Requests
longer than the arena are rejected (default) or served by a serial
fallback worker through the model's ordinary ``transcribe``.

The arena is float in the model's dtype whatever ``kv_dtype`` the model
has, as in the reference, and the tick's attention is the plain ``sdpa``
over it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.types import TranscriptionResult
from ..models.qwen3_asr.decoder import _qkv
from ..ops.attention import NEG_INF, sdpa
from ..ops.kv_cache import LayerKV
from ..ops.mel import num_frames
from ..ops.nn import embedding_lookup, linear, rms_norm, swiglu_mlp, tied_lm_head
from ..ops.sampling import SamplingOptions, log_softmax_confidence, sample_token
from .dispatch import BULK, LATENCY, gate_slot


@dataclasses.dataclass
class PoolState:
    """The device-resident slot arena (S = slots, T = max_len), updated in
    place by the tick thread."""

    layers: List[LayerKV]      # k/v [S, Hkv, T, D] in the model's dtype
    valid: torch.Tensor        # [S, T] bool — attendable rows
    positions: torch.Tensor    # [S] int32 — next RoPE position
    cursors: torch.Tensor      # [S] int64 — next write row
    active: torch.Tensor       # [S] bool — slot owns a request
    done: torch.Tensor         # [S] bool — hit EOS / budget (dormant)
    last_tok: torch.Tensor     # [S] int64
    steps: torch.Tensor        # [S] int32 — tokens generated so far
    budget: torch.Tensor       # [S] int32 — per-slot max_new


def _write_rows(layer: LayerKV, k_new, v_new, cursors) -> None:
    """Per-row single-token write: k_new [S, Hkv, 1, D] lands at row
    ``cursors[s]`` of slot s (one indexed write, no host sync). Dormant
    slots write garbage at their cursor; harmless: their cursor never
    advances and the row is never marked valid, so the next live write
    overwrites it."""
    rows = torch.arange(cursors.shape[0], device=cursors.device)
    layer.k[rows, :, cursors] = k_new[:, :, 0].to(layer.k.dtype)
    layer.v[rows, :, cursors] = v_new[:, :, 0].to(layer.v.dtype)


def _decode_step_rows(params, cfg, state: PoolState, live) -> torch.Tensor:
    """One token step over the whole pool with PER-ROW cursors (the
    shared-cursor ``decoder.decode_step`` stays untouched). Writes the
    step's k/v into the arena and returns logits fp32 [S, V]."""
    s = state.last_tok.shape[0]
    x = embedding_lookup(params["embed_tokens"], state.last_tok, cfg.hidden_size)[:, None, :]
    positions = state.positions[:, None]
    t_max = state.valid.shape[1]
    written = (torch.arange(t_max, device=x.device)[None, :] == state.cursors[:, None]) & live[:, None]
    key_ok = state.valid | written
    mask = torch.where(key_ok, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
    for layer, p in zip(state.layers, params["layers"]):
        h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
        q, k, v = _qkv(p, h, positions, cfg)
        _write_rows(layer, k, v, state.cursors)
        attn = sdpa(q, layer.k, layer.v, 1.0 / np.sqrt(cfg.head_dim), mask)
        x = x + linear(attn.transpose(1, 2).reshape(s, 1, -1), p["o_proj"])
        h2 = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
        x = x + swiglu_mlp(h2, p["mlp"])
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    return tied_lm_head(x[:, 0], params["embed_tokens"])


class _Req(NamedTuple):
    audio: np.ndarray
    sample_rate: int
    language: Optional[str]
    context: Optional[str]
    max_new: int
    fut: Future
    priority: str = "bulk"


class _ReadyGroup(NamedTuple):
    """A prefilled admission group: device-resident prompt segments plus
    host bookkeeping, made by the admit worker, inserted by the tick thread."""

    seg_layers: list       # list[LayerKV]: [B, Hkv, t_prompt, D]
    seg_valid: torch.Tensor   # [B, t_prompt] bool
    pos0: torch.Tensor     # [B] int32
    tok0: torch.Tensor     # [B] int64 (device)
    done0: torch.Tensor    # [B] bool (device)
    budgets: List[int]
    t_prompt: int
    tok0_host: list        # [B] int
    lp0_host: list         # [B] float
    futs: list             # [B] Future
    durations: list        # [B] float seconds
    language: Optional[str]


class SlotPoolASR:
    """Continuous-batching front-end over a loaded port :class:`Qwen3ASR`.

        pool = SlotPoolASR(model, slots=8, max_new=160)
        futs = [pool.submit(clip) for clip in clips]   # any time, any length
        texts = [f.result().text for f in futs]
        pool.close()
    """

    def __init__(self, model, slots: int = 8, max_len: Optional[int] = None,
                 max_new: int = 448, tick_tokens: int = 8,
                 options: Optional[SamplingOptions] = None,
                 admit_batch: int = 4, oversize: str = "reject"):
        if oversize not in ("reject", "fallback"):
            raise ValueError(f"oversize must be 'reject' or 'fallback', got {oversize!r}")
        opts = options or SamplingOptions(max_tokens=max_new)
        if opts.repetition_penalty != 1.0 or opts.no_repeat_ngram:
            # penalties need the per-slot token history on device; the
            # pool keeps history on the host (ASR defaults are greedy)
            raise ValueError("slot pool supports greedy/temperature/top_k "
                             "sampling (no repetition penalties)")
        if opts.beam > 1:
            raise ValueError("slot pool decodes one hypothesis per slot; "
                             "use model.transcribe(options=SamplingOptions("
                             "beam=K)) for beam search")
        self.model = model
        self.cfg = model.cfg
        dcfg = model.cfg.decoder
        self.slots = slots
        self.max_new = max_new
        self.tick_tokens = tick_tokens
        self.opts = opts
        self.admit_batch = max(1, admit_batch)
        self.oversize = oversize
        # the default arena covers the second-smallest audio bucket; serving
        # passes an explicit budget through max_len_for
        if max_len is None:
            buckets = model._audio_buckets_s
            bucket_s = buckets[1] if len(buckets) > 1 else buckets[0]
            max_len = self.max_len_for(model, float(bucket_s), max_new)
        self.max_len = max_len

        dev = model.device
        shape = (slots, dcfg.num_kv_heads, max_len, dcfg.head_dim)
        with torch.inference_mode():   # the workers update it inside inference mode
            self._state = PoolState(
                layers=[LayerKV(torch.zeros(shape, dtype=model.dtype, device=dev),
                                torch.zeros(shape, dtype=model.dtype, device=dev))
                        for _ in range(dcfg.num_layers)],
                valid=torch.zeros((slots, max_len), dtype=torch.bool, device=dev),
                positions=torch.zeros((slots,), dtype=torch.int32, device=dev),
                cursors=torch.zeros((slots,), dtype=torch.int64, device=dev),
                active=torch.zeros((slots,), dtype=torch.bool, device=dev),
                done=torch.ones((slots,), dtype=torch.bool, device=dev),
                last_tok=torch.zeros((slots,), dtype=torch.int64, device=dev),
                steps=torch.zeros((slots,), dtype=torch.int32, device=dev),
                budget=torch.zeros((slots,), dtype=torch.int32, device=dev))
        self._gen = torch.Generator(device=dev).manual_seed(0)    # tick thread only
        self._agen = torch.Generator(device=dev).manual_seed(1)   # admit thread only

        # host-side bookkeeping
        self._served = 0
        self._ticks = 0
        self._tick_trace: List[tuple] = []  # (end_ts, gated_s, total_s)
        self._admit_groups = 0
        self._admit_reqs = 0
        self._free: List[int] = list(range(slots))
        self._live: dict = {}       # slot -> _Live
        self._arrivals: "queue.Queue[_Req]" = queue.Queue()
        # latency-class arrivals jump the bulk admission queue
        self._arrivals_hi: "queue.Queue[_Req]" = queue.Queue()
        self._ready: "queue.Queue[_ReadyGroup]" = queue.Queue()
        # credits bound (live slots + prepared segments) ≤ slots, so the
        # admit worker never prefills a prompt the arena can't hold yet
        self._credits = threading.Semaphore(slots)
        self._closed = False
        self._submit_lock = threading.Lock()
        self._wake = threading.Event()
        self._admit_done = threading.Event()
        self._fb_queue: Optional[queue.Queue] = None
        self._fb_thread: Optional[threading.Thread] = None
        self._admit_thread = threading.Thread(target=self._admit_loop, daemon=True)
        self._admit_thread.start()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #

    @staticmethod
    def max_len_for(model, seconds: float, max_new: int = 448) -> int:
        """Arena rows needed to admit a ``seconds``-long clip with a
        ``max_new`` decode budget (exact encoder token math + prompt
        headroom)."""
        enc = model.cfg.encoder
        frames = model._frames_bucket(int(round(seconds * 100)))
        a_pad = frames // enc.chunk_frames * enc.tokens_per_chunk
        return a_pad + 96 + max_new

    def _prompt_len_for(self, audio: np.ndarray, sample_rate: int,
                        language: Optional[str], context: Optional[str]):
        """Host-only exact prompt length and group key of one request:
        (bucket_frames, t_prompt, pb, sb)."""
        # imported here: the model imports ``serving.dispatch``, whose
        # package imports this module
        from ..models.qwen3_asr.model import _round_block

        model = self.model
        n = len(audio)
        if sample_rate != model.mel_cfg.sample_rate:
            n = int(round(n * model.mel_cfg.sample_rate / sample_rate))
        n = max(n, 2)
        bucket = model._frames_bucket(num_frames(model.mel_cfg, n))
        enc = model.cfg.encoder
        a_pad = bucket // enc.chunk_frames * enc.tokens_per_chunk
        prefix, suffix = model._build_prompt(language, context)
        pb, sb = _round_block(len(prefix)), _round_block(len(suffix))
        return bucket, pb + a_pad + sb, pb, sb

    def submit(self, audio: np.ndarray, sample_rate: int = 16000,
               language: Optional[str] = None, context: Optional[str] = None,
               max_new: Optional[int] = None, max_tokens: Optional[int] = None,
               priority: str = "bulk") -> Future:
        """Queue one utterance; resolves to a TranscriptionResult.
        ``max_tokens`` aliases ``max_new`` (``ContinuousBatcher.submit``'s
        name); ``priority="latency"`` jumps the bulk admission queue."""
        if priority not in ("bulk", "latency"):
            raise ValueError(f"priority must be 'bulk' or 'latency', got {priority!r}")
        fut: Future = Future()
        req = _Req(audio, sample_rate, language, context,
                   max_new or max_tokens or self.max_new, fut, priority)
        with self._submit_lock:
            # pairs with close(): once _closed flips under the lock no
            # request can slip in after the final drain
            if self._closed:
                raise RuntimeError("pool is closed")
            (self._arrivals_hi if priority == "latency" else self._arrivals).put(req)
        self._wake.set()
        return fut

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16000,
                   timeout: float = 300.0, **kw):
        return self.submit(audio, sample_rate, **kw).result(timeout=timeout)

    def transcribe_all(self, audios: Sequence[np.ndarray], **kw) -> List:
        """Submit everything, wait for everything."""
        futs = [self.submit(a, **kw) for a in audios]
        return [f.result() for f in futs]

    def close(self) -> None:
        with self._submit_lock:
            self._closed = True
        self._wake.set()
        self._admit_thread.join(timeout=120)
        self._thread.join(timeout=120)
        if self._fb_thread is not None:
            self._fb_queue.put(None)
            self._fb_thread.join(timeout=120)
        # fail anything a dying thread left behind
        for q in (self._arrivals, self._arrivals_hi, self._ready):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                futs = item.futs if isinstance(item, _ReadyGroup) else [item.fut]
                for f in futs:
                    if not f.done():
                        f.set_exception(RuntimeError("pool is closed"))

    #: ContinuousBatcher-compatible alias (the server's shutdown path)
    shutdown = close

    @property
    def in_flight(self) -> int:
        return (len(self._live) + self._arrivals.qsize()
                + self._arrivals_hi.qsize() + self._ready.qsize())

    @property
    def stats(self) -> dict:
        return {
            "scheduler": "slotpool",
            "slots": self.slots,
            "free_slots": len(self._free),
            "in_flight": self.in_flight,
            "requests_served": self._served,
            "ticks_run": self._ticks,
            "admit_groups": self._admit_groups,
            "mean_admit_group": round(self._admit_reqs / self._admit_groups, 2)
            if self._admit_groups else 0.0,
            **self._tick_stats(),
        }

    def _tick_stats(self) -> dict:
        trace = list(self._tick_trace)
        if not trace:
            return {}
        g = sorted(w for _, w, _ in trace)
        t = sorted(w for _, _, w in trace)
        q = lambda xs, f: xs[min(len(xs) - 1, int(f * len(xs)))]  # noqa: E731
        return {
            "tick_ms_p50": round(q(g, 0.5) * 1e3, 1),
            "tick_ms_p90": round(q(g, 0.9) * 1e3, 1),
            "tick_incl_gate_ms_p50": round(q(t, 0.5) * 1e3, 1),
        }

    # ------------------------------------------------------------------ #
    # admission worker
    # ------------------------------------------------------------------ #

    def _oversize(self, req: _Req, t_prompt: int) -> None:
        err = ValueError(
            f"prompt {t_prompt} + budget {req.max_new} exceeds pool "
            f"max_len {self.max_len}; raise max_len or shorten audio")
        if self.oversize == "reject":
            req.fut.set_exception(err)
            return
        # fallback: the model's ordinary path on a serial worker (the
        # dispatch gate interleaves its chunks with pool ticks)
        if self._fb_thread is None:
            self._fb_queue = queue.Queue()
            self._fb_thread = threading.Thread(target=self._fb_run, daemon=True)
            self._fb_thread.start()
        self._fb_queue.put(req)

    def _fb_run(self) -> None:
        while True:
            r = self._fb_queue.get()
            if r is None:
                return
            try:
                res = self.model.transcribe(
                    r.audio, r.sample_rate, language=r.language, context=r.context,
                    options=dataclasses.replace(self.opts, max_tokens=r.max_new))
                r.fut.set_result(res)
                self._served += 1
            except Exception as e:  # noqa: BLE001 — the worker must keep serving
                r.fut.set_exception(e)

    def _collect(self) -> Optional[List[_Req]]:
        """Block for the next arrival — latency-class first — and drain
        more of the SAME class (they batch if they share a group key).
        None when closed and both queues are drained."""
        while True:
            try:
                first = self._arrivals_hi.get_nowait()
                src = self._arrivals_hi
                break
            except queue.Empty:
                pass
            try:
                first = self._arrivals.get(timeout=0.05)
                src = self._arrivals
                break
            except queue.Empty:
                if self._closed:
                    return None
        reqs = [first]
        while len(reqs) < self.admit_batch:
            try:
                reqs.append(src.get_nowait())
            except queue.Empty:
                break
        return reqs

    def _admit_loop(self) -> None:
        with torch.inference_mode():
            while True:
                reqs = self._collect()
                if reqs is None:
                    self._admit_done.set()
                    self._wake.set()
                    return
                self._admit(reqs)

    def _admit(self, reqs: List[_Req]) -> None:
        # route oversize before taking credits; group the rest
        groups: dict = {}
        for r in reqs:
            try:
                bucket, t_prompt, pb, sb = self._prompt_len_for(
                    r.audio, r.sample_rate, r.language, r.context)
            except Exception as e:  # noqa: BLE001 — a bad request fails alone
                r.fut.set_exception(e)
                continue
            if t_prompt + r.max_new > self.max_len:
                self._oversize(r, t_prompt)
                continue
            key = (bucket, pb, sb, r.language, r.context, r.sample_rate)
            groups.setdefault(key, []).append(r)
        for members in groups.values():
            i = 0
            while i < len(members):
                # group size = largest power of two ≤ min(waiting,
                # admit_batch, credits actually acquired): acquiring a whole
                # group's worth before encoding deadlocks when the group is
                # larger than the arena's free slots
                want = min(len(members) - i, self.admit_batch)
                got = 1
                self._acquire_credit()
                while got < want and self._credits.acquire(blocking=False):
                    got += 1
                take = 1 << (got.bit_length() - 1)
                for _ in range(got - take):
                    self._credits.release()
                chunk = members[i:i + take]
                i += take
                try:
                    self._admit_group(chunk)
                except Exception as e:  # noqa: BLE001 — fail the group, keep admitting
                    for r in chunk:
                        if not r.fut.done():
                            r.fut.set_exception(e)
                        self._credits.release()

    def _acquire_credit(self) -> None:
        # blocks until a slot will be free; retirement releases credits.
        # No closed-abort: close() drains in-flight work to completion.
        while not self._credits.acquire(timeout=0.5):
            pass

    def _admit_group(self, reqs: List[_Req]) -> None:
        model = self.model
        st = model.prestage([r.audio for r in reqs], reqs[0].sample_rate)
        with gate_slot(model.dispatch_gate, LATENCY):
            audio_tokens, n_audio = model._encode(st)
            if model.dispatch_gate is not None:
                model._sync()  # the encode completes before its slot is released
        b = len(reqs)
        prompt = model._prompt(b, reqs[0].language, reqs[0].context)
        t_prompt = prompt.prefix_ids.shape[1] + audio_tokens.shape[1] + prompt.suffix_ids.shape[1]
        worst = max(r.max_new for r in reqs)
        if t_prompt + worst > self.max_len:
            # the host estimate and the encode disagree (defensive)
            raise ValueError(
                f"prompt {t_prompt} + budget {worst} exceeds pool "
                f"max_len {self.max_len}; raise max_len or shorten audio")
        with gate_slot(model.dispatch_gate, LATENCY):
            logits, cache, valid = model._prefill(audio_tokens, n_audio, prompt, t_prompt,
                                                  model.dtype)
            tok0 = sample_token(logits, self.opts, self._agen)
            lp0 = log_softmax_confidence(logits, tok0)
            tok0_host = tok0.tolist()   # value fetch before the gate's release
        self._ready.put(_ReadyGroup(
            seg_layers=cache.layers, seg_valid=valid, pos0=cache.positions,
            tok0=tok0, done0=tok0 == self.cfg.eos_id,
            budgets=[r.max_new for r in reqs], t_prompt=t_prompt,
            tok0_host=tok0_host, lp0_host=lp0.tolist(),
            futs=[r.fut for r in reqs],
            durations=[len(r.audio) / r.sample_rate for r in reqs],
            language=reqs[0].language))
        self._admit_groups += 1
        self._admit_reqs += b
        self._wake.set()

    # ------------------------------------------------------------------ #
    # tick thread
    # ------------------------------------------------------------------ #

    class _Live(NamedTuple):
        fut: Future
        tokens: list
        logprobs: list
        duration: float
        language: Optional[str]

    def _insert_group(self, g: _ReadyGroup) -> None:
        """Copy a group's prompt segments into free slots (credits
        guarantee free slots ≥ prepared segments)."""
        slot_ids = [self._free.pop() for _ in range(len(g.futs))]
        st, tp = self._state, g.t_prompt
        dev = st.valid.device
        idx = torch.tensor(slot_ids, dtype=torch.int64, device=dev)
        for arena, seg in zip(st.layers, g.seg_layers):
            arena.k[idx, :, :tp] = seg.k[:, :, :tp].to(arena.k.dtype)
            arena.v[idx, :, :tp] = seg.v[:, :, :tp].to(arena.v.dtype)
        rows = torch.zeros((len(slot_ids), st.valid.shape[1]), dtype=torch.bool, device=dev)
        rows[:, :tp] = g.seg_valid[:, :tp]
        budget = torch.tensor(g.budgets, dtype=torch.int32, device=dev)
        st.valid[idx] = rows
        st.positions[idx] = g.pos0
        st.cursors[idx] = tp
        st.active[idx] = True
        st.done[idx] = g.done0 | (budget <= 1)   # the prefill token spent 1 of the budget
        st.last_tok[idx] = g.tok0
        st.steps[idx] = 1
        st.budget[idx] = budget
        for slot, fut, t0, l0, dur in zip(slot_ids, g.futs, g.tok0_host, g.lp0_host,
                                          g.durations):
            self._live[slot] = SlotPoolASR._Live(fut=fut, tokens=[t0], logprobs=[l0],
                                                 duration=dur, language=g.language)

    def _tick(self, n: int):
        """``n`` decode steps of every slot with no host sync. Returns
        (tokens [S, n], logprobs [S, n], done [S]) on the device."""
        cfg = self.cfg
        st, opts = self._state, self.opts
        t_max = st.valid.shape[1]
        rows = torch.arange(t_max, device=st.valid.device)[None, :]
        toks, lps = [], []
        for _ in range(n):
            live = st.active & ~st.done
            logits = _decode_step_rows(self.model.decoder_params, cfg.decoder, st, live)
            tok = sample_token(logits, opts, self._gen)
            if opts.force_eos_after:
                tok = torch.where(st.steps >= opts.force_eos_after,
                                  torch.full_like(tok, cfg.eos_id), tok)
            lp = log_softmax_confidence(logits, tok)
            tok = torch.where(live, tok, torch.full_like(tok, cfg.pad_id))
            lp = torch.where(live, lp, torch.zeros_like(lp))
            hit_eos = live & (tok == cfg.eos_id)
            emit = live & ~hit_eos
            # valid row + cursor/position advance only for emitting rows
            st.valid |= (rows == st.cursors[:, None]) & emit[:, None]
            st.steps += emit
            st.done |= hit_eos | (st.steps >= st.budget)
            st.positions += emit
            st.cursors += emit
            st.last_tok = torch.where(emit, tok, st.last_tok)
            toks.append(tok)
            lps.append(lp)
        return torch.stack(toks, dim=1), torch.stack(lps, dim=1), st.done.clone()

    def _retire(self, slot: int) -> None:
        live = self._live.pop(slot)
        ids = [t for t in live.tokens if t != self.cfg.eos_id]
        model = self.model
        if model.tokenizer:
            text = model.tokenizer.decode(ids, skip_special=True)
            if "<asr_text>" in text:
                text = text.split("<asr_text>", 1)[1].strip()
            text = text.strip()
        else:
            text = " ".join(map(str, ids))
        lps = live.logprobs[:max(len(ids), 1)]
        conf = float(np.exp(np.mean(lps))) if ids else 0.0
        live.fut.set_result(TranscriptionResult(
            text=text, language=live.language, confidence=conf,
            duration=live.duration, processing_time=0.0))
        self._served += 1
        self._free.append(slot)
        self._credits.release()

    def _run(self) -> None:
        with torch.inference_mode():
            self._tick_loop()

    def _tick_loop(self) -> None:
        model = self.model
        pad = self.cfg.pad_id
        while True:
            # insert everything the admit worker prepared (small copies;
            # never encode or prefill here)
            while True:
                try:
                    g = self._ready.get_nowait()
                except queue.Empty:
                    break
                self._insert_group(g)
            if not self._live:
                if self._closed and self._admit_done.is_set() and self._ready.empty():
                    return
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            t_q = time.perf_counter()
            with gate_slot(model.dispatch_gate, BULK):
                t_g = time.perf_counter()
                toks, lps, done = self._tick(self.tick_tokens)
                toks = toks.cpu().numpy()   # value fetch = sync
            t_e = time.perf_counter()
            # per-tick trace (end timestamp, gated device+fetch s, incl.
            # gate-wait s), a bounded ring
            self._tick_trace.append((t_e, t_e - t_g, t_e - t_q))
            if len(self._tick_trace) > 8192:
                del self._tick_trace[:4096]
            self._ticks += 1
            lps = lps.cpu().numpy()
            done = done.cpu().numpy()
            for slot, live in list(self._live.items()):   # once per tick, not per step
                for t, lp in zip(toks[slot].tolist(), lps[slot].tolist()):
                    if t != pad:
                        live.tokens.append(t)
                        live.logprobs.append(lp)
                if done[slot]:
                    self._retire(slot)
