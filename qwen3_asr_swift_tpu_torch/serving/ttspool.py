"""Frame-level continuous batching for Qwen3-TTS: a slot-pool talker —
port of ``qwen3_asr_swift_tpu/serving/ttspool.py``.

N concurrent syntheses share one talker step and one code-predictor chain
per 12.5 Hz frame (the weights are read once a frame for the whole pool;
with packed weights every decode-shaped product runs kernel K1), and a new
synthesis joins the running batch at a frame boundary:

- a fixed ``[slots, max_len]`` talker-KV arena in the model's dtype, with
  per-slot cursors, positions, repetition rings, frame budgets and a
  per-slot trailing-text buffer (each slot streams its own text
  embedding per frame, then tts_pad);
- the ADMIT worker builds the prompt, prefills the talker for the prompt's
  block and samples the first frame (code0 and the CP chain), off the tick
  thread; the tick thread copies the prompt's KV segment into a free slot
  (one indexed write per layer);
- each TICK advances every live slot by ``tick_frames`` frames with no
  host sync: talker step with per-row cursors (the arena rows written by
  ``slotpool._write_rows``), code0 sampled as the solo loop samples it,
  the CP chain, per-slot record masks;
- EOS or the budget retires a slot; a finisher thread decodes its codes
  (at the solo path's frame bucket), so vocoding never blocks a tick.

Greedy pooled == greedy solo: admission reproduces the solo prefill and
the tick is the solo loop's body with per-row cursors. Prompts whose
blocks exceed the arena, and voice-clone prompts, are rejected (default)
or served by a serial fallback through the model's ``synthesize`` on the
same device. Both workers enter ``torch.inference_mode`` themselves and
draw from their own ``torch.Generator`` (tick seeded 0, admission 1).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.types import AudioChunk
from ..models.qwen3_tts.code_predictor import embed_all_groups, predict_codebooks
from ..models.qwen3_tts.config import CodecTokens
from ..models.qwen3_tts.model import TTSSamplingConfig, sample_code0
from ..models.qwen3_tts.talker import (_finish_layer, _rotated, embed_codec, embed_text,
                                       make_talker_cache, mrope_angles, talker_prefill)
from ..ops.attention import NEG_INF, sdpa
from ..ops.kv_cache import LayerKV
from ..ops.nn import linear, rms_norm
from .dispatch import BULK, LATENCY, gate_slot
from .slotpool import _write_rows


@dataclasses.dataclass
class TTSPoolState:
    """The device-resident slot arena (S = slots, T = max_len, TB = the
    trailing-text block, W = the repetition window), updated in place by
    the tick thread."""

    layers: List[LayerKV]      # k/v [S, Hkv, T, D] in the model's dtype
    valid: torch.Tensor        # [S, T] bool
    positions: torch.Tensor    # [S] int64
    cursors: torch.Tensor      # [S] int64
    active: torch.Tensor       # [S] bool
    done: torch.Tensor         # [S] bool
    code0: torch.Tensor        # [S] int64 — last frame's codebook-0 token
    cp_codes: torch.Tensor     # [S, 15] int64 — last frame's CP codes
    rep_ring: torch.Tensor     # [S, W] int64 (-1 = empty)
    step: torch.Tensor         # [S] int64 — frames emitted so far
    budget: torch.Tensor       # [S] int64 — max frames
    trail: torch.Tensor        # [S, TB, H] — per-slot trailing text embeddings
    trail_len: torch.Tensor    # [S] int64


def _talker_step_rows(tp, tcfg, state: TTSPoolState, x, live):
    """One talker step over the whole pool with per-row cursors (the rows
    variant of ``talker.talker_step``). x [S, 1, H]. Writes the step's k/v
    into the arena; returns (logits fp32 [S, V], hidden [S, H])."""
    s = x.shape[0]
    t_max = state.valid.shape[1]
    written = ((torch.arange(t_max, device=x.device)[None, :] == state.cursors[:, None])
               & live[:, None])
    mask = torch.where(state.valid | written, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
    cos, sin = mrope_angles(state.positions[None, :, None].expand(3, s, 1), tcfg.head_dim,
                            tcfg.mrope_sections, tcfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]
    for layer, p in zip(state.layers, tp["layers"]):
        q, k, v = _rotated(p, x, cos, sin, tcfg)
        _write_rows(layer, k, v, state.cursors)
        x = _finish_layer(p, x, sdpa(q, layer.k, layer.v, 1.0 / np.sqrt(tcfg.head_dim), mask),
                          tcfg)
    x = rms_norm(x, tp["norm"]["weight"], tcfg.rms_norm_eps)
    return linear(x[:, 0], tp["codec_head"]).float(), x[:, 0]


class _Req(NamedTuple):
    text: str
    language: str
    voice: Optional[str]
    max_frames: int
    fut: Future


class _Ready(NamedTuple):
    seg_layers: list           # list[LayerKV]: [1, Hkv, p_block, D]
    seg_valid: torch.Tensor    # [1, p_block]
    pos0: torch.Tensor         # [1]
    frame0: torch.Tensor       # [1, 16] (device)
    trailing: torch.Tensor     # [1, t_block, H]
    t_len: int
    p_block: int
    budget: int
    frame0_host: np.ndarray    # [16] — emitted at admission
    done0: bool
    fut: Future


class SlotPoolTTS:
    """Frame-level continuous batching over a loaded port :class:`Qwen3TTS`.

        pool = SlotPoolTTS(model, slots=4)
        futs = [pool.submit(text) for text in texts]     # any time
        wavs = [f.result() for f in futs]                # AudioChunk
        pool.close()
    """

    def __init__(self, model, slots: int = 4, max_frames: int = 500, tick_frames: int = 5,
                 sampling: Optional[TTSSamplingConfig] = None, max_p_block: int = 128,
                 max_t_block: int = 128, oversize: str = "reject"):
        if oversize not in ("reject", "fallback"):
            raise ValueError(f"oversize must be 'reject' or 'fallback', got {oversize!r}")
        self.model = model
        self.sampling = sampling or model.sampling    # else as a solo call samples
        self.slots = slots
        self.max_frames = min(max_frames, self.sampling.max_frames)
        self.tick_frames = tick_frames
        self.max_p_block = max_p_block
        self.max_t_block = max_t_block
        self.oversize = oversize
        tcfg = model.cfg.talker
        self.max_len = max_len = max_p_block + self.max_frames
        dev, dtype = model.device, model.dtype
        shape = (slots, tcfg.num_kv_heads, max_len, tcfg.head_dim)

        def zeros(*size, dt=torch.int64):
            return torch.zeros(size, dtype=dt, device=dev)

        with torch.inference_mode():   # the workers update it inside inference mode
            self._state = TTSPoolState(
                layers=[LayerKV(zeros(*shape, dt=dtype), zeros(*shape, dt=dtype))
                        for _ in range(tcfg.num_layers)],
                valid=zeros(slots, max_len, dt=torch.bool), positions=zeros(slots),
                cursors=zeros(slots), active=zeros(slots, dt=torch.bool),
                done=torch.ones((slots,), dtype=torch.bool, device=dev),
                code0=zeros(slots), cp_codes=zeros(slots, 15),
                rep_ring=torch.full((slots, self.sampling.rep_window), -1, dtype=torch.int64,
                                    device=dev),
                step=zeros(slots), budget=zeros(slots),
                trail=zeros(slots, max_t_block, tcfg.hidden_size, dt=dtype),
                trail_len=zeros(slots))
            # the tts_pad embedding is a model constant
            self._tts_pad = embed_text(model.talker_params,
                                       torch.tensor([[tcfg.tts_pad_id]], device=dev),
                                       tcfg)[0, 0].to(dtype)
        self._gen = torch.Generator(device=dev).manual_seed(0)    # tick thread only
        self._agen = torch.Generator(device=dev).manual_seed(1)   # admit thread only

        # host bookkeeping (the protocol of SlotPoolASR)
        self._served = 0
        self._ticks = 0
        self._free: List[int] = list(range(slots))
        self._live: dict = {}
        self._arrivals: "queue.Queue[_Req]" = queue.Queue()
        self._ready: "queue.Queue[_Ready]" = queue.Queue()
        self._finish: "queue.Queue" = queue.Queue()
        self._credits = threading.Semaphore(slots)
        self._closed = False
        self._submit_lock = threading.Lock()
        self._wake = threading.Event()
        self._admit_done = threading.Event()
        self._fb_queue: Optional[queue.Queue] = None
        self._fb_thread: Optional[threading.Thread] = None
        self._admit_thread = threading.Thread(target=self._admit_loop, daemon=True)
        self._admit_thread.start()
        self._finish_thread = threading.Thread(target=self._finish_loop, daemon=True)
        self._finish_thread.start()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #

    def submit(self, text: str, language: str = "english", voice: Optional[str] = None,
               max_frames: Optional[int] = None) -> Future:
        """Queue one synthesis; resolves to an AudioChunk."""
        fut: Future = Future()
        req = _Req(text, language, voice, max_frames or self.max_frames, fut)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("pool is closed")
            self._arrivals.put(req)
        self._wake.set()
        return fut

    def synthesize(self, text: str, timeout: float = 600.0, **kw):
        return self.submit(text, **kw).result(timeout=timeout)

    def close(self) -> None:
        with self._submit_lock:
            self._closed = True
        self._wake.set()
        self._admit_thread.join(timeout=300)
        self._thread.join(timeout=300)
        self._finish.put(None)
        self._finish_thread.join(timeout=300)
        if self._fb_thread is not None:
            self._fb_queue.put(None)
            self._fb_thread.join(timeout=300)
        # fail anything a dying thread left behind
        for q in (self._arrivals, self._ready):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if not item.fut.done():
                    item.fut.set_exception(RuntimeError("pool is closed"))

    shutdown = close

    @property
    def stats(self) -> dict:
        return {
            "scheduler": "ttspool",
            "slots": self.slots,
            "free_slots": len(self._free),
            "in_flight": len(self._live) + self._arrivals.qsize() + self._ready.qsize(),
            "requests_served": self._served,
            "ticks_run": self._ticks,
        }

    # ------------------------------------------------------------------ #
    # admission worker
    # ------------------------------------------------------------------ #

    def _fallback(self, req: _Req, reason: str) -> None:
        if self.oversize == "reject":
            req.fut.set_exception(ValueError(reason))
            return
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
                r.fut.set_result(self.model.synthesize(
                    r.text, voice=r.voice, language=r.language,
                    sampling=dataclasses.replace(self.sampling, max_frames=r.max_frames)))
                self._served += 1
            except Exception as e:  # noqa: BLE001 — the worker must keep serving
                r.fut.set_exception(e)

    def _admit_loop(self) -> None:
        with torch.inference_mode():
            while True:
                try:
                    req = self._arrivals.get(timeout=0.05)
                except queue.Empty:
                    if self._closed:
                        self._admit_done.set()
                        self._wake.set()
                        return
                    continue
                try:
                    self._admit_one(req)
                except Exception as e:  # noqa: BLE001 — a bad request fails alone
                    if not req.fut.done():
                        req.fut.set_exception(e)

    def _admit_prefill(self, prefill, p_len: int, p_block: int):
        """The solo loop's prefill and first frame for one prompt."""
        model = self.model
        tcfg = model.cfg.talker
        dev = model.device
        cache = make_talker_cache(tcfg, 1, p_block, model.dtype, device=dev)
        valid = torch.arange(p_block, device=dev)[None] < p_len
        logits, hidden, cache = talker_prefill(model.talker_params, tcfg, prefill, valid, cache)
        ring0 = torch.full((1, self.sampling.rep_window), -1, dtype=torch.int64, device=dev)
        frame0 = model._first_frame(logits[:, p_len - 1], hidden[:, p_len - 1], ring0,
                                    self.sampling, self._agen)
        return cache.layers, valid, cache.positions, frame0

    def _admit_one(self, req: _Req) -> None:
        model = self.model
        if req.voice and model.ref_cache.get(req.voice) is not None:
            # a voice clone splices its reference frames into the prefill:
            # variable length, the eager prompt path
            self._fallback(req, "voice-clone prompts use the eager prompt path; pool "
                                "admission supports built-in speakers only")
            return
        prefill, trailing, _, p_len, t_len, p_block, t_block = \
            model._build_prompt_fused(req.text, req.language, req.voice)
        if p_block > self.max_p_block or t_block > self.max_t_block:
            self._fallback(req, f"prompt blocks ({p_block}, {t_block}) exceed pool arena "
                                f"({self.max_p_block}, {self.max_t_block}); raise "
                                f"max_p_block/max_t_block or shorten the text")
            return
        while not self._credits.acquire(timeout=0.5):
            pass
        try:
            with gate_slot(getattr(model, "dispatch_gate", None), LATENCY):
                seg_layers, seg_valid, pos0, frame0 = self._admit_prefill(prefill, p_len, p_block)
                frame0_host = frame0[0].cpu().numpy()   # value fetch = sync
            self._ready.put(_Ready(
                seg_layers=seg_layers, seg_valid=seg_valid, pos0=pos0, frame0=frame0,
                trailing=trailing, t_len=t_len, p_block=p_block, budget=req.max_frames,
                frame0_host=frame0_host, done0=bool(frame0_host[0] == CodecTokens.EOS),
                fut=req.fut))
            self._wake.set()
        except Exception:
            self._credits.release()
            raise

    # ------------------------------------------------------------------ #
    # tick thread
    # ------------------------------------------------------------------ #

    class _Live(NamedTuple):
        fut: Future
        frames: list   # np [16] each
        budget: int

    def _insert(self, g: _Ready) -> None:
        """Copy a prompt's segment and state into a free slot (credits
        guarantee one)."""
        slot = self._free.pop()
        st, pb = self._state, g.p_block
        for arena, seg in zip(st.layers, g.seg_layers):
            arena.k[slot, :, :pb] = seg.k[0, :, :pb].to(arena.k.dtype)
            arena.v[slot, :, :pb] = seg.v[0, :, :pb].to(arena.v.dtype)
        st.valid[slot] = False
        st.valid[slot, :pb] = g.seg_valid[0, :pb]
        st.trail[slot] = 0
        st.trail[slot, :g.trailing.shape[1]] = g.trailing[0].to(st.trail.dtype)
        code0 = g.frame0[0, 0]
        st.rep_ring[slot] = -1
        st.rep_ring[slot, 0] = torch.where(code0 == CodecTokens.EOS, -1, code0)
        st.positions[slot] = g.pos0[0]
        st.cursors[slot] = pb
        st.active[slot] = True
        st.done[slot] = g.done0 or g.budget <= 1
        st.code0[slot] = code0
        st.cp_codes[slot] = g.frame0[0, 1:]
        st.step[slot] = 1
        st.budget[slot] = g.budget
        st.trail_len[slot] = g.t_len
        self._live[slot] = SlotPoolTTS._Live(
            fut=g.fut, frames=[] if g.done0 else [g.frame0_host], budget=g.budget)
        if g.done0 or g.budget <= 1:
            self._retire(slot)

    def _tick(self, n: int):
        """``n`` frames of every slot with no host sync. Returns (frames
        [S, n, 16], recorded [S, n], done [S]) on the device."""
        model, st, sampling = self.model, self._state, self.sampling
        tp, cpp = model.talker_params, model.cp_params
        tcfg, cpcfg = model.cfg.talker, model.cfg.code_predictor
        rows = torch.arange(self.slots, device=st.valid.device)
        arena_rows = torch.arange(self.max_len, device=st.valid.device)[None, :]
        frames, recs = [], []
        for _ in range(n):
            live = st.active & ~st.done
            t_idx = (st.step - 1).clamp(0, st.trail.shape[1] - 1)
            text_emb = torch.where(((st.step - 1) < st.trail_len)[:, None], st.trail[rows, t_idx],
                                   self._tts_pad[None])
            codec_emb = embed_codec(tp, st.code0) + embed_all_groups(cpp, cpcfg, st.cp_codes)
            x = (text_emb + codec_emb)[:, None].to(model.dtype)
            logits, hidden = _talker_step_rows(tp, tcfg, st, x, live)
            code0 = sample_code0(logits, st.rep_ring, sampling, self._gen)
            cp = predict_codebooks(cpp, cpcfg, hidden.to(model.dtype),
                                   embed_codec(tp, code0).to(model.dtype), self._gen,
                                   temperature=sampling.temperature, top_k=sampling.top_k)
            record = live & (code0 != CodecTokens.EOS)
            ring_idx = st.step % sampling.rep_window
            st.rep_ring[rows, ring_idx] = torch.where(record, code0, st.rep_ring[rows, ring_idx])
            st.valid |= (arena_rows == st.cursors[:, None]) & record[:, None]
            st.step += record
            st.done |= (code0 == CodecTokens.EOS) | (st.step >= st.budget)
            st.positions += record
            st.cursors += record
            st.code0 = torch.where(record, code0, st.code0)
            st.cp_codes = torch.where(record[:, None], cp, st.cp_codes)
            frames.append(torch.cat([code0[:, None], cp], dim=1))
            recs.append(record)
        return torch.stack(frames, dim=1), torch.stack(recs, dim=1), st.done.clone()

    def _retire(self, slot: int) -> None:
        live = self._live.pop(slot)
        self._free.append(slot)
        self._credits.release()
        self._finish.put(live)

    def _finish_loop(self) -> None:
        """Codec decode off the tick thread, one program per retired
        synthesis (gated BULK), at the frame bucket the solo path uses."""
        model = self.model
        sr = model.cfg.codec.sample_rate
        with torch.inference_mode():
            while True:
                live = self._finish.get()
                if live is None:
                    return
                try:
                    n = len(live.frames)
                    if n == 0:
                        live.fut.set_result(AudioChunk(np.zeros(0, np.float32), sr))
                    else:
                        # the solo loop's code buffer: max_frames rows, zeros after n
                        codes = np.zeros((1, max(live.budget, n), 16), np.int64)
                        codes[0, :n] = np.stack(live.frames)
                        with gate_slot(getattr(model, "dispatch_gate", None), BULK):
                            wav = model.codec.decode_frames(
                                torch.from_numpy(codes).to(model.device), n)[0]
                        live.fut.set_result(AudioChunk(np.asarray(wav, np.float32), sr))
                    self._served += 1
                except Exception as e:  # noqa: BLE001 — the worker must keep serving
                    if not live.fut.done():
                        live.fut.set_exception(e)

    def _run(self) -> None:
        with torch.inference_mode():
            self._tick_loop()

    def _tick_loop(self) -> None:
        model = self.model
        while True:
            while self._free:
                try:
                    g = self._ready.get_nowait()
                except queue.Empty:
                    break
                self._insert(g)
            if not self._live:
                if self._closed and self._admit_done.is_set() and self._ready.empty():
                    return
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            with gate_slot(getattr(model, "dispatch_gate", None), BULK):
                frames, recs, done = self._tick(self.tick_frames)
                frames = frames.cpu().numpy()   # value fetch = sync
            self._ticks += 1
            recs = recs.cpu().numpy()
            done = done.cpu().numpy()
            for slot, live in list(self._live.items()):
                for j in range(recs.shape[1]):
                    if recs[slot, j]:
                        live.frames.append(frames[slot, j])
                if done[slot]:
                    self._retire(slot)
