"""The Qwen3-ASR family: batched transcription through the port's
``Qwen3ASR.transcribe_batch``, in a closed loop.

The weights and clips are the benchmark's (``reference/qwen3_asr.py``,
``traffic.py``), drawn on the card from the seed; the program packs its
decoder from the raw draw (``ops.quant.quantize_tree``) as its loader
would. Set-up warms the cell's one batch shape: a whole batch with the
full decode budget, stopped by EOS after the first chunk.

Spans and ranges are the benchmark's, around the model instance's
``prestage``, ``_encode``, ``_prefill``, ``_gen_chunk`` and ``_all_done``;
the served tokens are read where ``_finalize`` receives them.
"""

from __future__ import annotations

import copy
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference.qwen3_asr import Reference, draw_weights, fp8_rows, token_gaps
from ..traffic import check_sample, clip_samples, draw_batch

#: the methods wrapped in spans (host clock) and, while profiling, ranges
SPANNED = ("prestage", "_encode", "_prefill", "_gen_chunk", "_all_done")
#: kernel name marks of K1 and K3 in the device trace
K1_MARKS = ("quant_matmul_kernel", "split_sum")
K3_MARKS = ("decode_attn_int8_split", "decode_attn_int8_merge")
DECODE_RANGE = "_gen_chunk"


def _program_config(cfg: dict):
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr.config import (AudioEncoderConfig,
                                                                    Qwen3ASRConfig,
                                                                    TextDecoderConfig)

    s = cfg["serving"]
    dec = TextDecoderConfig(**cfg["decoder"], group_size=s["group_size"], bits=s["quant_bits"])
    return Qwen3ASRConfig(encoder=AudioEncoderConfig(**cfg["encoder"]), decoder=dec,
                          **cfg["special_tokens"])


def build_program(cfg: dict, enc: dict, dec: dict, device):
    """The port's model from the raw trees, as the configuration serves it."""
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR
    from qwen3_asr_swift_tpu_torch.ops.mel import MelConfig
    from qwen3_asr_swift_tpu_torch.ops.quant import quantize_tree

    s = cfg["serving"]
    m = cfg["mel"]
    wire = {"float32": np.float32, "int16": np.int16}.get(s["wire"], s["wire"])
    opts = dict(device=device, dtype=getattr(torch, s["dtype"]), wire_dtype=wire,
                kv_dtype=getattr(torch, s["kv_dtype"]),
                decode_chunk_tokens=s["decode_chunk_tokens"], quant_compute=s["quant_compute"],
                audio_buckets_s=tuple(s["audio_buckets_s"]),
                mel_cfg=MelConfig(sample_rate=m["sample_rate"], n_fft=m["n_fft"],
                                  hop_length=m["hop_length"], n_mels=m["n_mels"],
                                  padded_fft=m["padded_fft"],
                                  log_clamp_floor=m["log_clamp_floor"],
                                  dynamic_range=m["dynamic_range"]))
    packed = quantize_tree(dec, s["quant_bits"], s["group_size"])
    return Qwen3ASR.from_params(_program_config(cfg), enc, packed, **opts)


class Runner:
    """One run of a cell: set-up, batches, a profiled batch, the check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, log=print):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.log = log
        self.model = None
        self.pool: List[List[np.ndarray]] = []
        #: (batch, name, host start s, host end s), recorded while ``spans_on``
        self.spans: List[tuple] = []
        self.spans_on = False
        self.ranges_on = False
        #: decode steps of each batch run
        self.steps: List[int] = []
        #: (batch, row, samples, tokens served) of every request answered
        self.requests: List[tuple] = []
        self.tokens: Dict[int, np.ndarray] = {}
        self.batch = 0
        self.failed = 0
        #: the KV cache's rows, read from the last batch run with spans on
        self.cache_len = 0

    # -- set-up ------------------------------------------------------------ #

    def setup(self) -> None:
        """Weights, the program, the clips and the warm-up; logs each part's seconds."""
        parts, t0 = {}, time.perf_counter()

        def part(name):
            nonlocal t0
            self._sync()
            parts[name] = time.perf_counter() - t0
            t0 = time.perf_counter()

        if self.device.type == "cuda":
            torch.cuda.init()
            torch.empty(1, device=self.device)
            part("context")
            from qwen3_asr_swift_tpu_torch.ops import cuda_build

            cuda_build.library()
            part("library")
        enc, dec = draw_weights(self.cfg, self.seed, self.device)
        part("draw")
        self.model = build_program(self.cfg, enc, dec, self.device)
        del enc, dec
        self._instrument()
        part("build")
        t = self.traffic
        self.pool = [draw_batch(t, self.seed, i, self.device) for i in range(t["pool_batches"])]
        part("clips")
        from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

        warm = SamplingOptions(max_tokens=t["max_tokens"], force_eos_after=1)
        self.model.transcribe_batch(self.pool[0], sample_rate=t["sample_rate"], options=warm)
        part("warm-up")
        self.log("set-up parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
        self.steps.clear()
        self.tokens.clear()
        self.requests.clear()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _instrument(self) -> None:
        from torch.profiler import record_function

        from ..trace import PREFIX

        model = self.model
        for name in SPANNED:
            orig = getattr(model, name)

            def wrapped(*a, _orig=orig, _name=name, **kw):
                if not self.spans_on:
                    return _orig(*a, **kw)
                if _name == "_gen_chunk" and a[0].step == 1:
                    self._sync()   # the decode's span starts once prefill has run
                t0 = time.perf_counter()
                if self.ranges_on:
                    with record_function(PREFIX + _name):
                        out = _orig(*a, **kw)
                else:
                    out = _orig(*a, **kw)
                self.spans.append((self.batch, _name, t0, time.perf_counter()))
                if _name == "_prefill":
                    self.cache_len = out[1].max_len
                return out

            setattr(model, name, wrapped)
        finalize = model._finalize

        def capture(tokens, n_gen, logprobs, n_req, *rest):
            self.tokens[self.batch] = tokens.copy()
            return finalize(tokens, n_gen, logprobs, n_req, *rest)

        model._finalize = capture

    # -- the window -------------------------------------------------------- #

    def run_batch(self) -> dict:
        """Send one batch and wait for it: {"audio_s", "requests", "failed"}."""
        t = self.traffic
        index = self.batch
        clips = self.pool[index % len(self.pool)]
        results = self.model.transcribe_batch(clips, sample_rate=t["sample_rate"],
                                              max_tokens=t["max_tokens"])
        self.steps.append(self.model.last_loop["decode_steps"])
        tokens = self.tokens.get(index)
        failed = 0
        for row, clip in enumerate(clips):
            ok = (row < len(results) and np.isfinite(results[row].confidence)
                  and tokens is not None)
            if ok:
                self.requests.append((index, row, len(clip), self._served(tokens[row]).size))
            else:
                failed += 1
        self.failed += failed
        self.batch += 1
        return {"audio_s": sum(len(c) for c in clips) / t["sample_rate"], "requests": len(clips),
                "failed": failed}

    def _served(self, row_tokens: np.ndarray) -> np.ndarray:
        """A row's tokens up to and with its first EOS."""
        eos = np.nonzero(row_tokens == self.cfg["special_tokens"]["eos_id"])[0]
        return row_tokens[: eos[0] + 1] if eos.size else row_tokens

    def profiled_batch(self) -> dict:
        """One batch under the profiler, with ranges; what the readers need."""
        from qwen3_asr_swift_tpu_torch.ops.attention_int8 import K3_LAUNCHES
        from qwen3_asr_swift_tpu_torch.ops.quant import K1_LAUNCHES

        from ..trace import profile_window

        k1, k3 = K1_LAUNCHES.value, K3_LAUNCHES.value
        self.ranges_on = True
        try:
            trace = profile_window(self.run_batch)
        finally:
            self.ranges_on = False
        samples = self.batch_samples(self.batch - 1)
        trace.update(steps=self.steps[-1], rows=len(samples), samples=samples,
                     cache_len=self.cache_len, decode_range=DECODE_RANGE,
                     launches={"k1": K1_LAUNCHES.value - k1, "k3": K3_LAUNCHES.value - k3},
                     marks={"k1": K1_MARKS, "k3": K3_MARKS})
        return trace

    def batch_samples(self, index: int) -> List[int]:
        """Samples of each clip of batch ``index``."""
        return clip_samples(self.traffic, self.seed, index % len(self.pool))

    def release(self) -> None:
        """Free the program and its state on the device."""
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------- #

    def check(self, controls=()) -> dict:
        """The served tokens of a sample of the answered requests against the
        reference: {"logit_gap": the widest gap of a served token's logit
        below the reference's best, "row_gap": the largest of the sampled
        rows' mean gaps}; then, for each name ``c`` of ``controls``, "c.logit_gap"
        and "c.row_gap" of the token that the control puts first at the same
        positions."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        enc, dec = draw_weights(self.cfg, self.seed, self.device)
        ref = Reference(self.cfg, enc, dec, self.device)
        del enc, dec
        others = {}
        for name in controls:
            others[name] = copy.copy(ref)
            others[name].act = CONTROLS[name]
        out = {f"{c}{k}": 0.0 for c in [""] + [n + "." for n in others]
               for k in ("logit_gap", "row_gap")}

        def take(prefix, gaps):
            out[prefix + "logit_gap"] = max(out[prefix + "logit_gap"], float(gaps.max()))
            out[prefix + "row_gap"] = max(out[prefix + "row_gap"], float(gaps.mean()))

        picked = check_sample(self.traffic, self.seed, self.requests)
        with torch.inference_mode():
            for i in picked:
                batch, row, _, _ = self.requests[i]
                clip = self.pool[batch % len(self.pool)][row]
                served = torch.from_numpy(self._served(self.tokens[batch][row]).astype(np.int64))
                audio = torch.from_numpy(clip).to(self.device)
                logits = ref.logits(audio, served)
                take("", token_gaps(logits, served))
                for name, other in others.items():
                    take(name + ".", token_gaps(logits, other.logits(audio, served).argmax(-1)))
        out["checked_tokens"] = sum(self.requests[i][3] for i in picked)
        return out


#: lower precisions a control reference computes in
CONTROLS = {"fp8_control": fp8_rows}


def expected_launches(cfg: dict, steps: int) -> Dict[str, int]:
    """Launches of K1 and K3 in one batch of ``steps`` decode steps: the
    prefill's head and every step's products; K3 once a layer a step."""
    from ..costs.qwen3_asr import k1_decode_launches

    k3 = steps * cfg["decoder"]["num_layers"] if cfg["serving"]["kv_dtype"] == "int8" else 0
    return {"k1": 1 + k1_decode_launches(cfg, steps), "k3": k3}
