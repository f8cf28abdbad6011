"""`speech` command-line interface of the PyTorch/CUDA port — port of the
subcommands of ``qwen3_asr_swift_tpu/cli.py`` whose models are ported:
``transcribe``, ``transcribe-batch``, ``align``, ``speak`` (and its aliases
``qwen3-tts`` and ``qwen3-tts-coreml``), ``respond`` (PersonaPlex),
``vad`` (Silero, Pyannote or FireRed), ``vad-stream``, ``diarize`` (the
Silero + WeSpeaker pipeline), ``embed-speaker`` (WeSpeaker or CAM++),
``denoise`` (DeepFilterNet3), ``separate`` (Open-Unmix), ``translate``
(MADLAD-400), ``chat`` (Qwen3.5), ``vibevoice`` and
``vibevoice-encode-voice`` (VibeVoice), ``kokoro`` (Kokoro-82M),
``voxcpm2`` (VoxCPM2) and ``serve``. ``wake`` is not in the parser yet,
and ``diarize --engine sortformer`` raises (ROADMAP §1).

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
    if engine == "pyannote":
        from .models.pyannote import PyannoteVAD as Model
    elif engine == "firered":
        from .models.firered_vad import FireRedVAD as Model
    else:
        from .models.silero_vad import SileroVAD as Model

    if args.random_weights:
        model = Model.init_random(device=args.device)
    elif args.model:
        model = Model.from_pretrained(args.model, device=args.device)
    else:
        # each engine has its own checkpoint default — passing the silero
        # id to pyannote/firered would convert the wrong repo
        model = Model.from_pretrained(device=args.device)
    audio, _ = _load_audio(args.audio)
    segs = model.detect_speech(audio)
    _print([{"start": round(s.start, 3), "end": round(s.end, 3)} for s in segs])


def cmd_diarize(args):
    audio, _ = _load_audio(args.audio)
    if getattr(args, "engine", "pipeline") == "sortformer":
        raise NotImplementedError(
            "the Sortformer diarizer is not ported yet (ROADMAP §1 item 5, with Parakeet's "
            "encoder); use --engine pipeline")
    from .models.diarization import DiarizationPipeline
    from .models.silero_vad import SileroVAD
    from .models.speaker import WeSpeaker

    if args.random_weights:
        pipe = DiarizationPipeline(SileroVAD.init_random(device=args.device),
                                   WeSpeaker.init_random(device=args.device))
    else:
        pipe = DiarizationPipeline(SileroVAD.from_pretrained(device=args.device),
                                   WeSpeaker.from_pretrained(device=args.device))
    segs = pipe.diarize(audio, num_speakers=args.num_speakers)
    _print([{"start": round(s.start, 2), "end": round(s.end, 2), "speaker": int(s.speaker)}
            for s in segs])


def cmd_embed_speaker(args):
    import numpy as np

    if "campplus" in args.model.lower() or "cam++" in args.model.lower():
        from .models.speaker import CampPlusSpeaker as Model
    else:
        from .models.speaker import WeSpeaker as Model

    model = (Model.init_random(device=args.device) if args.random_weights
             else Model.from_pretrained(args.model, device=args.device))
    audio, _ = _load_audio(args.audio)
    emb = model.embed(audio)
    if args.compare:
        other, _ = _load_audio(args.compare)
        sim = float(np.dot(emb, model.embed(other)))
        _print({"similarity": sim, "dim": len(emb)})
    else:
        _print({"dim": len(emb), "norm": float(np.linalg.norm(emb)),
                "embedding": [round(float(x), 4) for x in emb[:8]] + ["..."]})


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


def cmd_separate(args):
    from .audio.io import read_wav, write_wav
    from .models.separation import SourceSeparator

    model = (SourceSeparator.init_random(device=args.device) if args.random_weights
             else SourceSeparator.from_pretrained(args.model, device=args.device))
    audio, rate = read_wav(args.audio)
    stems = model.separate(audio, rate, stems=args.stems)
    outs = {}
    for stem, wav in stems.items():
        path = args.output_prefix + f"_{stem}.wav"
        write_wav(path, wav.mean(axis=0), 44100)
        outs[stem] = path
    _print(outs)


def cmd_translate(args):
    from .models.translation import MADLADTranslator, config_tiny

    model = (MADLADTranslator.init_random(config_tiny(), device=args.device)
             if args.random_weights else MADLADTranslator.from_pretrained(args.model,
                                                                          device=args.device))
    if args.random_weights:
        _print({"note": "random weights — structural smoke only",
                "ids": model.translate_ids([5, 9, 13, 1], max_new=8)})
    else:
        _print({"translation": model.translate(args.text, target_lang=args.target)})


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


def cmd_kokoro(args):
    from .audio.io import write_wav
    from .models.kokoro import KokoroTTS, config_tiny

    model = (KokoroTTS.init_random(config_tiny(), device=args.device) if args.random_weights
             else KokoroTTS.from_pretrained(args.model, device=args.device))
    chunk = model.synthesize(args.text, voice=args.voice, language=args.language,
                             speed=args.speed)
    write_wav(args.output, chunk.samples, chunk.sample_rate)
    _print({"output": args.output, "seconds": len(chunk.samples) / chunk.sample_rate,
            "voices": model.available_voices})


def cmd_voxcpm2(args):
    from .audio.io import write_wav
    from .models.voxcpm2 import VoxCPM2TTS, config_tiny

    model = (VoxCPM2TTS.init_random(config_tiny(), device=args.device) if args.random_weights
             else VoxCPM2TTS.from_pretrained(args.model, device=args.device))
    voice = None
    if args.voice:
        voice, _ = _load_audio(args.voice, rate=model.cfg.sample_rate)
    chunk = model.synthesize(args.text, voice=voice, instruct=args.instruct)
    write_wav(args.output, chunk.samples, chunk.sample_rate)
    _print({"output": args.output, "seconds": len(chunk.samples) / chunk.sample_rate})


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
    add("kokoro", cmd_kokoro, text={}, **{
        "--model": dict(default="hexgrad/Kokoro-82M"), "--voice": dict(default=None),
        "--language": dict(default="en"), "--speed": dict(type=float, default=1.0),
        "--output": dict(default="out.wav")})
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
    add("diarize", cmd_diarize, audio={}, **{
        "--num-speakers": dict(type=int, default=None),
        "--engine": dict(default="pipeline", choices=["pipeline", "sortformer"])})
    add("embed-speaker", cmd_embed_speaker, audio={}, **{
        "--model": dict(default="wespeaker-resnet34"), "--compare": dict(default=None)})
    add("denoise", cmd_denoise, audio={}, **{
        "--model": dict(default="deepfilternet3"), "--output": dict(default="denoised.wav")})
    sp = sub.add_parser("separate")
    sp.set_defaults(fn=cmd_separate)
    sp.add_argument("audio")
    sp.add_argument("--random-weights", action="store_true")
    sp.add_argument("--model", default="open-unmix/umxhq")
    sp.add_argument("--stems", nargs="*", default=None)
    sp.add_argument("--output-prefix", default="stem")
    add("translate", cmd_translate, text={}, **{
        "--model": dict(default="google/madlad400-3b-mt"), "--target": dict(default="en")})
    add("chat", cmd_chat, message={}, **{"--model": dict(default="Qwen/Qwen3.5-0.8B")})
    add("vibevoice", cmd_vibevoice, text={}, **{
        "--model": dict(default="microsoft/VibeVoice-Realtime-0.5B"),
        "--voice": dict(default=None), "--output": dict(default="out.wav")})
    add("vibevoice-encode-voice", cmd_vibevoice_encode_voice, audio={}, **{
        "--model": dict(default="microsoft/VibeVoice-Realtime-0.5B"),
        "--transcript": dict(default=None), "--output": dict(default="voice_cache.npz")})
    add("voxcpm2", cmd_voxcpm2, text={}, **{
        "--model": dict(default="openbmb/VoxCPM2"),
        "--voice": dict(default=None, help="reference audio for cloning"),
        "--instruct": dict(default=None, help="voice-design instruction"),
        "--output": dict(default="out.wav")})
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
