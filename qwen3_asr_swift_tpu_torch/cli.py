"""`speech` command-line interface of the PyTorch/CUDA port — port of the
subcommands of ``qwen3_asr_swift_tpu/cli.py`` whose models are ported:
``transcribe``, ``transcribe-batch``, ``align``, ``speak`` (and its aliases
``qwen3-tts`` and ``qwen3-tts-coreml``), ``respond`` (PersonaPlex),
``vad``, ``vad-stream``, ``denoise`` (DeepFilterNet3), ``chat`` (Qwen3.5),
``vibevoice`` and ``vibevoice-encode-voice`` (VibeVoice) and ``serve``. The other families' subcommands are not in the parser yet
(ROADMAP §1).

Every model runs on ``--device`` (default ``cuda``, the first card; a
request for a card on a machine without one raises); nothing picks the CPU
unless ``--device cpu`` asks for it. ``--random-weights`` builds each
model from a seed at the reference's tiny config (byte-level tokenizer)
for smoke tests without a checkpoint; ``--model`` takes a local checkpoint
directory (hub download is not ported). The output is the reference's
JSON.

Usage: python -m qwen3_asr_swift_tpu_torch.cli [--device cpu] <command> [options]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_audio(path: str, rate: int = 16000):
    from .audio.io import load_audio

    return load_audio(path, target_rate=rate)


def _print(obj):
    print(json.dumps(obj, ensure_ascii=False, indent=2, default=str))


def byte_tokenizer():
    """The byte-level tokenizer the random-weight models use."""
    from .tokenizers.bpe import BPETokenizer, _bytes_to_unicode

    b2u = _bytes_to_unicode()
    return BPETokenizer({ch: i for i, ch in enumerate(b2u[b] for b in range(256))}, [])


# ---------------------------------------------------------------------------
# command implementations
# ---------------------------------------------------------------------------

def _asr(args):
    from .models.qwen3_asr import Qwen3ASR, config_tiny

    if args.random_weights:
        return Qwen3ASR.init_random(config_tiny(), audio_buckets_s=(8,), device=args.device)
    return Qwen3ASR.from_pretrained(args.model, device=args.device)


def cmd_transcribe(args):
    model = _asr(args)
    audio, _ = _load_audio(args.audio)
    opts = None
    if args.beam > 1:
        from .ops.sampling import SamplingOptions

        opts = SamplingOptions(max_tokens=args.max_tokens, beam=args.beam)
    res = model.transcribe(audio, language=args.language, context=args.context,
                           max_tokens=args.max_tokens, options=opts)
    _print({"text": res.text, "confidence": res.confidence, "duration": res.duration,
            "rtf": res.rtf})


def cmd_transcribe_batch(args):
    model = _asr(args)
    audios = [_load_audio(p)[0] for p in args.audio]
    results = model.transcribe_batch(audios, language=args.language, max_tokens=args.max_tokens)
    _print([{"file": p, "text": r.text, "confidence": r.confidence}
            for p, r in zip(args.audio, results)])


def cmd_align(args):
    import torch

    from .models.qwen3_asr import Qwen3ForcedAligner

    if args.random_weights:
        model = Qwen3ForcedAligner.init_random(dtype=torch.float32, tokenizer=byte_tokenizer(),
                                               device=args.device)
    else:
        model = Qwen3ForcedAligner.from_pretrained(args.model, device=args.device)
    audio, _ = _load_audio(args.audio)
    words = model.align(audio, args.text, language=args.language)
    _print([{"word": w.word, "start": round(w.start, 3), "end": round(w.end, 3)} for w in words])


def cmd_speak(args):
    import torch

    from .audio.io import write_wav
    from .models.qwen3_tts import Qwen3TTS, TTSSamplingConfig, config_tiny

    if args.random_weights:
        model = Qwen3TTS.init_random(config_tiny(), dtype=torch.float32,
                                     tokenizer=byte_tokenizer(), device=args.device)
        sampling = TTSSamplingConfig(max_frames=8, temperature=0.0)
    else:
        model = Qwen3TTS.from_pretrained(args.model, device=args.device)
        sampling = TTSSamplingConfig()
    chunk = model.synthesize(args.text, voice=args.voice, language=args.language,
                             instruct=args.instruct, sampling=sampling)
    write_wav(args.output, chunk.samples, chunk.sample_rate)
    _print({"output": args.output, "seconds": len(chunk.samples) / chunk.sample_rate})


def cmd_vad(args):
    engine = getattr(args, "engine", "silero")
    if engine != "silero":
        raise NotImplementedError(
            f"the {engine} VAD is not ported yet (ROADMAP §1 item 3, the other families); "
            f"use --engine silero")
    from .models.silero_vad import SileroVAD

    if args.random_weights:
        model = SileroVAD.init_random(device=args.device)
    elif args.model:
        model = SileroVAD.from_pretrained(args.model, device=args.device)
    else:
        model = SileroVAD.from_pretrained(device=args.device)
    audio, _ = _load_audio(args.audio)
    segs = model.detect_speech(audio)
    _print([{"start": round(s.start, 3), "end": round(s.end, 3)} for s in segs])


def cmd_respond(args):
    from .audio.io import write_wav
    from .models.personaplex import PersonaPlex, PersonaSampling, config_tiny

    if args.random_weights:
        model = PersonaPlex.init_random(config_tiny(), device=args.device)
        sampling = PersonaSampling(audio_temperature=0.0, max_steps=8)
    else:
        model = PersonaPlex.from_pretrained(args.model, device=args.device)
        sampling = PersonaSampling()
    audio, rate = _load_audio(args.audio, rate=model.cfg.mimi.sample_rate)
    # the model resolves the string: path-like → load the file (plain
    # missing-file error), bare name → snapshot preset
    voice = args.voice_prompt
    result = {"output": args.output}
    if args.diagnostic:
        out, diag = model.respond_diagnostic(audio, rate, sampling=sampling,
                                             voice_prompt=voice,
                                             system_prompt=args.system_prompt)
        result["diagnostic"] = {
            "text_tokens": diag["text_tokens"].tolist(),
            "text_entropy": [round(float(e), 3) for e in diag["text_entropy"]],
            "hidden_mean_range": [round(float(diag["hidden_stats"][:, 0].min()), 4),
                                  round(float(diag["hidden_stats"][:, 0].max()), 4)],
        }
    else:
        out = model.respond(audio, rate, sampling=sampling, voice_prompt=voice,
                            system_prompt=args.system_prompt)
    write_wav(args.output, out.samples, out.sample_rate)
    result["seconds"] = len(out.samples) / out.sample_rate
    _print(result)


def cmd_denoise(args):
    from .audio.io import write_wav
    from .models.enhancement import SpeechEnhancer

    model = (SpeechEnhancer.init_random(device=args.device) if args.random_weights
             else SpeechEnhancer.from_pretrained(args.model, device=args.device))
    audio, rate = _load_audio(args.audio, rate=48000)
    out = model.enhance(audio, rate)
    write_wav(args.output, out.samples, out.sample_rate)
    _print({"output": args.output})


def cmd_vad_stream(args):
    from .models.silero_vad import SileroVAD, StreamingVADProcessor

    model = (SileroVAD.init_random(device=args.device) if args.random_weights
             else SileroVAD.from_pretrained(args.model, device=args.device))
    proc = StreamingVADProcessor(model)
    audio, _ = _load_audio(args.audio)
    step = 16000 // 4
    for off in range(0, len(audio), step):
        for ev in proc.process(audio[off: off + step]):
            print(f"{ev.time:8.2f}s {ev.type.value}")
    for ev in proc.flush():
        print(f"{ev.time:8.2f}s {ev.type.value}")


def chat_tokenizer(n_bytes: int = 200):
    """The byte-level tokenizer of the random-weight chat model: the first
    ``n_bytes`` byte tokens and the two chat-template specials after them
    (the reference's CLI takes 200; 256 covers every byte)."""
    from .tokenizers.bpe import BPETokenizer, _bytes_to_unicode

    b2u = _bytes_to_unicode()
    return BPETokenizer({b2u[b]: b for b in range(n_bytes)}, [],
                        {"<|im_start|>": n_bytes, "<|im_end|>": n_bytes + 1})


def cmd_chat(args):
    from .models.chat import Qwen3Chat, config_tiny

    if args.random_weights:
        model = Qwen3Chat.init_random(config_tiny(), tokenizer=chat_tokenizer(),
                                      device=args.device)
    else:
        model = Qwen3Chat.from_pretrained(args.model, device=args.device)
    for piece in model.chat([{"role": "user", "content": args.message}]):
        print(piece, end="", flush=True)
    print()


def _vibevoice(args):
    from .models.vibevoice import VibeVoiceTTS, config_tiny

    if args.random_weights:
        return VibeVoiceTTS.init_random(config_tiny(), device=args.device)
    return VibeVoiceTTS.from_pretrained(args.model, device=args.device)


def cmd_vibevoice(args):
    from .audio.io import write_wav

    chunk = _vibevoice(args).synthesize(args.text, voice=args.voice)
    write_wav(args.output, chunk.samples, chunk.sample_rate)
    _print({"output": args.output, "seconds": len(chunk.samples) / chunk.sample_rate})


def cmd_vibevoice_encode_voice(args):
    model = _vibevoice(args)
    audio, _ = _load_audio(args.audio, rate=24000)
    path = model.encode_voice(audio, args.transcript or "", args.output)
    _print({"voice_cache": str(path)})


def cmd_serve(args):
    import asyncio

    from .serving.server import ModelRegistry, SpeechServer

    registry = ModelRegistry()
    decode_chunk = args.decode_chunk or None

    def load_asr():
        import torch

        from .models.qwen3_asr import Qwen3ASR, config_tiny

        if args.random_weights:
            return Qwen3ASR.init_random(config_tiny(), dtype=torch.float32,
                                        tokenizer=byte_tokenizer(), audio_buckets_s=(8,),
                                        decode_chunk_tokens=decode_chunk, device=args.device)
        return Qwen3ASR.from_pretrained(decode_chunk_tokens=decode_chunk, device=args.device)

    registry.register("asr", load_asr)
    server = SpeechServer(registry, host=args.host, port=args.port, scheduler=args.scheduler,
                          slotpool_max_s=args.slotpool_max_s, bulk_nice=args.bulk_nice)
    asyncio.run(server.serve_forever())


# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="speech", description="speech toolkit on PyTorch/CUDA")
    p.add_argument("--device", default="cuda", metavar="DEVICE",
                   help="'cuda' (the first card, the default), 'cuda:N' or 'cpu'")
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, fn, **arguments):
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("--random-weights", action="store_true",
                        help="random init (no checkpoint download)")
        for arg, kw in arguments.items():
            sp.add_argument(arg.replace("_", "-") if arg.startswith("--") else arg, **kw)
        return sp

    add("transcribe", cmd_transcribe, audio={}, **{
        "--model": dict(default="aufklarer/Qwen3-ASR-0.6B-MLX-4bit"),
        "--language": dict(default=None), "--context": dict(default=None),
        "--max-tokens": dict(type=int, default=448),
        "--beam": dict(type=int, default=0,
                       help="beam width for on-device beam search "
                            "(0 = greedy)")})
    sp = sub.add_parser("transcribe-batch")
    sp.set_defaults(fn=cmd_transcribe_batch)
    sp.add_argument("audio", nargs="+")
    sp.add_argument("--random-weights", action="store_true")
    sp.add_argument("--model", default="aufklarer/Qwen3-ASR-0.6B-MLX-4bit")
    sp.add_argument("--language", default=None)
    sp.add_argument("--max-tokens", type=int, default=448)

    add("align", cmd_align, audio={}, text={}, **{
        "--model": dict(default="aufklarer/Qwen3-ForcedAligner-0.6B-4bit"),
        "--language": dict(default="English")})
    add("speak", cmd_speak, text={}, **{
        "--model": dict(default="aufklarer/Qwen3-TTS-1.7B-MLX-4bit"),
        "--voice": dict(default=None), "--language": dict(default="english"),
        "--instruct": dict(default=None), "--output": dict(default="out.wav")})
    add("qwen3-tts", cmd_speak, text={}, **{
        "--model": dict(default="aufklarer/Qwen3-TTS-1.7B-MLX-4bit"),
        "--voice": dict(default=None), "--language": dict(default="english"),
        "--instruct": dict(default=None), "--output": dict(default="out.wav")})
    # the reference's name kept as an alias: the same model here
    add("qwen3-tts-coreml", cmd_speak, text={}, **{
        "--model": dict(default="aufklarer/Qwen3-TTS-0.6B-CoreML"),
        "--voice": dict(default=None), "--language": dict(default="english"),
        "--instruct": dict(default=None), "--output": dict(default="out.wav")})
    add("respond", cmd_respond, audio={}, **{
        "--model": dict(default="nvidia/personaplex-7b-v1"),
        "--output": dict(default="response.wav"),
        "--voice-prompt": dict(default=None,
                               help="voice .safetensors/.npz path, or a "
                                    "snapshot preset name (NATM0...)"),
        "--system-prompt": dict(default=None,
                                help="text steering prompt (SentencePiece'd; "
                                     "default: built-in assistant prompt)"),
        "--diagnostic": dict(action="store_true",
                             help="also print per-step text tokens / entropy "
                                  "/ hidden stats (respondDiagnostic)")})
    add("vad", cmd_vad, audio={}, **{
        "--model": dict(default=None, help="checkpoint id (default: the "
                                           "selected engine's own)"),
        "--engine": dict(default="silero", choices=["silero", "pyannote", "firered"])})
    add("vad-stream", cmd_vad_stream, audio={}, **{"--model": dict(default="silero-vad-v5")})
    add("denoise", cmd_denoise, audio={}, **{
        "--model": dict(default="deepfilternet3"), "--output": dict(default="denoised.wav")})
    add("chat", cmd_chat, message={}, **{"--model": dict(default="Qwen/Qwen3.5-0.8B")})
    add("vibevoice", cmd_vibevoice, text={}, **{
        "--model": dict(default="microsoft/VibeVoice-Realtime-0.5B"),
        "--voice": dict(default=None), "--output": dict(default="out.wav")})
    add("vibevoice-encode-voice", cmd_vibevoice_encode_voice, audio={}, **{
        "--model": dict(default="microsoft/VibeVoice-Realtime-0.5B"),
        "--transcript": dict(default=None), "--output": dict(default="voice_cache.npz")})
    add("serve", cmd_serve, **{
        "--host": dict(default="127.0.0.1"), "--port": dict(type=int, default=8321),
        "--decode-chunk": dict(
            type=int, default=15,
            help="tokens per dispatched ASR decode program; bounds how long "
                 "a newly arriving request waits behind an in-flight batch "
                 "(loaded first-token latency). 0 = monolithic decode"),
        "--scheduler": dict(
            default="group", choices=["group", "slotpool"],
            help="request scheduler: 'group' batches same-bucket FIFO groups; "
                 "'slotpool' is token-level (ASR) and frame-level (TTS) "
                 "continuous batching, admission at tick boundaries"),
        "--slotpool-max-s": dict(
            type=float, default=64.0,
            help="slotpool arena budget in seconds of audio: longer clips "
                 "divert to a serial fallback path instead of erroring; "
                 "arena memory scales with this"),
        "--bulk-nice": dict(
            type=int, default=None,
            help="OS nice for bulk batch-worker threads (e.g. 10): on a "
                 "core-starved host, keeps latency-sensitive handler work "
                 "ahead of bulk staging in the run queue")})
    return p


def main(argv=None):
    from .device import resolve_device

    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)
    t0 = time.perf_counter()
    args.fn(args)
    print(f"[{time.perf_counter() - t0:.1f}s]", file=sys.stderr)


if __name__ == "__main__":
    main()
