"""The port's CLI (``python -m qwen3_asr_swift_tpu_torch.cli``), ``respond``,
``denoise``, ``chat``, ``vibevoice``, ``vibevoice-encode-voice``, ``kokoro``,
``voxcpm2``, the three ``vad`` engines, ``diarize``, ``embed-speaker``,
``separate`` and ``translate`` included.

Each ported subcommand runs through ``main([..., "--device", "cpu",
"--random-weights"])``, prints the reference's JSON keys, and its result
equals a direct call of the port's API on the same seeded model. The
parser carries the reference's names, options and defaults for every
ported subcommand (``--device`` takes the place of ``--platform``). The
card is the default device: on a machine without one the CLI raises
unless ``--device cpu`` is given.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu import cli as jcli
from qwen3_asr_swift_tpu_torch import cli
from qwen3_asr_swift_tpu_torch.audio.io import load_audio, write_wav

REPO = Path(__file__).resolve().parent.parent
PORTED = ["transcribe", "transcribe-batch", "align", "speak", "qwen3-tts", "qwen3-tts-coreml",
          "respond", "vad", "vad-stream", "diarize", "embed-speaker", "denoise", "separate",
          "translate", "chat", "vibevoice", "vibevoice-encode-voice", "kokoro", "voxcpm2",
          "serve"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The frame loops are chains of small ops: with several test workers
    on the host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    paths = []
    for i, seconds in enumerate((1.5, 2.5)):
        t = np.arange(int(16000 * seconds)) / 16000
        burst = (np.sin(2 * np.pi * 220 * t) * (t > 0.5)).astype(np.float32)
        audio = (0.3 * burst + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        paths.append(str(d / f"clip{i}.wav"))
        write_wav(paths[-1], audio, 16000)
    return paths


def run(capsys, *argv):
    cli.main(["--device", "cpu", *argv])
    return capsys.readouterr().out


def asr_model():
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny

    return Qwen3ASR.init_random(config_tiny(), audio_buckets_s=(8,), device="cpu")


@pytest.mark.parametrize("beam", [0, 2])
def test_transcribe(capsys, clips, beam):
    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

    out = json.loads(run(capsys, "transcribe", clips[0], "--random-weights", "--max-tokens", "6",
                         "--beam", str(beam)))
    assert set(out) == {"text", "confidence", "duration", "rtf"}
    opts = SamplingOptions(max_tokens=6, beam=beam) if beam > 1 else None
    want = asr_model().transcribe(load_audio(clips[0], 16000)[0], max_tokens=6, options=opts)
    assert out["text"] == want.text and out["duration"] == pytest.approx(want.duration)


def test_transcribe_batch(capsys, clips):
    out = json.loads(run(capsys, "transcribe-batch", *clips, "--random-weights",
                         "--max-tokens", "5"))
    assert [set(r) for r in out] == [{"file", "text", "confidence"}] * 2
    want = asr_model().transcribe_batch([load_audio(p, 16000)[0] for p in clips], max_tokens=5)
    assert [r["text"] for r in out] == [w.text for w in want]
    assert [r["file"] for r in out] == clips


def test_align(capsys, clips):
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ForcedAligner

    out = json.loads(run(capsys, "align", clips[1], "hello big world", "--random-weights"))
    assert [set(w) for w in out] == [{"word", "start", "end"}] * 3
    model = Qwen3ForcedAligner.init_random(dtype=torch.float32, tokenizer=cli.byte_tokenizer(),
                                           device="cpu")
    words = model.align(load_audio(clips[1], 16000)[0], "hello big world", language="English")
    assert out == [{"word": w.word, "start": round(w.start, 3), "end": round(w.end, 3)}
                   for w in words]


@pytest.mark.parametrize("name", ["speak", "qwen3-tts", "qwen3-tts-coreml"])
def test_speak(capsys, tmp_path, name):
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts import Qwen3TTS, TTSSamplingConfig, config_tiny

    path = str(tmp_path / "out.wav")
    out = json.loads(run(capsys, name, "hello", "--random-weights", "--output", path))
    assert set(out) == {"output", "seconds"} and out["output"] == path
    audio, rate = load_audio(path)
    model = Qwen3TTS.init_random(config_tiny(), dtype=torch.float32,
                                 tokenizer=cli.byte_tokenizer(), device="cpu")
    want = model.synthesize("hello", sampling=TTSSamplingConfig(max_frames=8, temperature=0.0))
    assert rate == 24000 and len(audio) == len(want.samples) > 0
    assert out["seconds"] == len(want.samples) / 24000


def test_vad_and_stream(capsys, clips):
    from qwen3_asr_swift_tpu_torch.models.silero_vad import SileroVAD, StreamingVADProcessor

    out = json.loads(run(capsys, "vad", clips[1], "--random-weights"))
    vad = SileroVAD.init_random(device="cpu")
    audio = load_audio(clips[1], 16000)[0]
    assert out == [{"start": round(s.start, 3), "end": round(s.end, 3)}
                   for s in vad.detect_speech(audio)]
    assert all(set(s) == {"start", "end"} for s in out)
    lines = run(capsys, "vad-stream", clips[1], "--random-weights").splitlines()
    proc = StreamingVADProcessor(vad)
    want = []
    for off in range(0, len(audio), 4000):
        want += [f"{ev.time:8.2f}s {ev.type.value}" for ev in proc.process(audio[off:off + 4000])]
    want += [f"{ev.time:8.2f}s {ev.type.value}" for ev in proc.flush()]
    assert lines == want


@pytest.mark.parametrize("diagnostic", [False, True])
def test_respond(capsys, clips, tmp_path, diagnostic):
    from qwen3_asr_swift_tpu_torch.audio.io import read_wav, wav_bytes
    from qwen3_asr_swift_tpu_torch.models.personaplex import (PersonaPlex, PersonaSampling,
                                                              config_tiny)

    model = PersonaPlex.init_random(config_tiny(), device="cpu")
    voice = str(tmp_path / "voice.safetensors")
    model.make_voice_prompt(load_audio(clips[0], 24000)[0], 24000, path=voice)
    path = str(tmp_path / "response.wav")
    argv = ["respond", clips[1], "--random-weights", "--output", path, "--voice-prompt", voice]
    out = json.loads(run(capsys, *argv, *(["--diagnostic"] if diagnostic else [])))
    audio = load_audio(clips[1], 24000)[0]
    sampling = PersonaSampling(audio_temperature=0.0, max_steps=8)
    if diagnostic:
        want, diag = model.respond_diagnostic(audio, 24000, sampling=sampling, voice_prompt=voice)
        assert set(out) == {"output", "seconds", "diagnostic"}
        assert out["diagnostic"]["text_tokens"] == diag["text_tokens"].tolist()
        assert set(out["diagnostic"]) == {"text_tokens", "text_entropy", "hidden_mean_range"}
    else:
        want = model.respond(audio, 24000, sampling=sampling, voice_prompt=voice)
        assert set(out) == {"output", "seconds"}
    got, rate = read_wav(open(path, "rb").read())
    assert rate == 24000 and out["seconds"] == len(want.samples) / 24000
    np.testing.assert_array_equal(got, read_wav(wav_bytes(want.samples, 24000))[0])


def test_denoise(capsys, clips, tmp_path):
    from qwen3_asr_swift_tpu_torch.audio.io import read_wav, wav_bytes
    from qwen3_asr_swift_tpu_torch.models.enhancement import SpeechEnhancer

    path = str(tmp_path / "denoised.wav")
    out = json.loads(run(capsys, "denoise", clips[0], "--random-weights", "--output", path))
    assert out == {"output": path}
    audio = load_audio(clips[0], 48000)[0]
    want = SpeechEnhancer.init_random(device="cpu").enhance(audio, 48000)
    got, rate = read_wav(open(path, "rb").read())
    assert rate == 48000 and len(got) == len(audio)
    np.testing.assert_array_equal(got, read_wav(wav_bytes(want.samples, 48000))[0])


def test_chat(capsys):
    from qwen3_asr_swift_tpu_torch.models.chat import Qwen3Chat, config_tiny

    out = run(capsys, "chat", "hello there", "--random-weights")
    model = Qwen3Chat.init_random(config_tiny(), tokenizer=cli.chat_tokenizer(), device="cpu")
    want = "".join(model.chat([{"role": "user", "content": "hello there"}]))
    assert out == want + "\n"
    assert jcli.build_parser().parse_args(["chat", "hi"]).model == "Qwen/Qwen3.5-0.8B"


def test_vibevoice_and_encode_voice(capsys, clips, tmp_path):
    from qwen3_asr_swift_tpu_torch.audio.io import read_wav, wav_bytes
    from qwen3_asr_swift_tpu_torch.models.vibevoice import VibeVoiceTTS, config_tiny

    model = VibeVoiceTTS.init_random(config_tiny(), device="cpu")
    cache = str(tmp_path / "voice_cache.npz")
    out = json.loads(run(capsys, "vibevoice-encode-voice", clips[1], "--random-weights",
                         "--transcript", "hello", "--output", cache))
    assert out == {"voice_cache": cache}
    want = np.load(model.encode_voice(load_audio(clips[1], 24000)[0], "hello",
                                      str(tmp_path / "direct.npz")))
    got = np.load(cache)
    np.testing.assert_array_equal(got["latents"], want["latents"])
    assert str(got["transcript"]) == "hello"

    path = str(tmp_path / "out.wav")
    out = json.loads(run(capsys, "vibevoice", "hello there", "--random-weights", "--output", path,
                         "--voice", cache))
    want = model.synthesize("hello there", voice=cache)
    assert set(out) == {"output", "seconds"} and out["output"] == path
    assert out["seconds"] == len(want.samples) / 24000
    heard, rate = read_wav(open(path, "rb").read())
    assert rate == 24000
    np.testing.assert_array_equal(heard, read_wav(wav_bytes(want.samples, 24000))[0])


def test_kokoro(capsys, tmp_path):
    from qwen3_asr_swift_tpu_torch.audio.io import read_wav, wav_bytes
    from qwen3_asr_swift_tpu_torch.models.kokoro import KokoroTTS, config_tiny

    path = str(tmp_path / "out.wav")
    out = json.loads(run(capsys, "kokoro", "hello there", "--random-weights", "--output", path,
                         "--speed", "1.25"))
    want = KokoroTTS.init_random(config_tiny(), device="cpu").synthesize("hello there",
                                                                          speed=1.25)
    assert set(out) == {"output", "seconds", "voices"} and out["output"] == path
    assert out["seconds"] == len(want.samples) / 24000 and out["voices"] == ["af_heart"]
    heard, rate = read_wav(open(path, "rb").read())
    assert rate == 24000
    np.testing.assert_array_equal(heard, read_wav(wav_bytes(want.samples, 24000))[0])


@pytest.mark.parametrize("extra", [[], ["--instruct", "a calm voice"], ["--voice", "clip"]])
def test_voxcpm2(capsys, clips, tmp_path, extra):
    from qwen3_asr_swift_tpu_torch.audio.io import read_wav, wav_bytes
    from qwen3_asr_swift_tpu_torch.models.voxcpm2 import VoxCPM2TTS, config_tiny

    extra = [clips[1] if a == "clip" else a for a in extra]
    path = str(tmp_path / "out.wav")
    out = json.loads(run(capsys, "voxcpm2", "hello there", "--random-weights", "--output", path,
                         *extra))
    model = VoxCPM2TTS.init_random(config_tiny(), device="cpu")
    kw = {"instruct": "a calm voice"} if "--instruct" in extra else {}
    if "--voice" in extra:
        kw["voice"] = load_audio(clips[1], model.cfg.sample_rate)[0]
    want = model.synthesize("hello there", **kw)
    assert set(out) == {"output", "seconds"} and out["output"] == path
    assert out["seconds"] == len(want.samples) / 48000
    heard, rate = read_wav(open(path, "rb").read())
    assert rate == 48000
    np.testing.assert_array_equal(heard, read_wav(wav_bytes(want.samples, 48000))[0])


@pytest.mark.parametrize("engine", ["pyannote", "firered"])
def test_vad_other_engines_are_not_ported(capsys, clips, engine):
    """The other two engines, which raised until they were ported, run with
    their own random models and print the reference's keys and rounding:
    the segments of a direct ``detect_speech``."""
    from qwen3_asr_swift_tpu_torch.models.firered_vad import FireRedVAD
    from qwen3_asr_swift_tpu_torch.models.pyannote import PyannoteVAD

    out = json.loads(run(capsys, "vad", clips[1], "--random-weights", "--engine", engine))
    model = {"pyannote": PyannoteVAD, "firered": FireRedVAD}[engine].init_random(device="cpu")
    want = model.detect_speech(load_audio(clips[1], 16000)[0])
    assert out == [{"start": round(s.start, 3), "end": round(s.end, 3)} for s in want]
    assert jcli.build_parser().parse_args(["vad", "x", "--engine", engine]).model is None


def test_diarize(capsys, clips):
    """The pipeline engine over the random Silero and WeSpeaker: the
    reference's keys and rounding, equal to a direct ``diarize``; the
    Sortformer engine raises naming the roadmap."""
    from qwen3_asr_swift_tpu_torch.models.diarization import DiarizationPipeline
    from qwen3_asr_swift_tpu_torch.models.silero_vad import SileroVAD
    from qwen3_asr_swift_tpu_torch.models.speaker import WeSpeaker

    out = json.loads(run(capsys, "diarize", clips[1], "--random-weights", "--num-speakers", "1"))
    pipe = DiarizationPipeline(SileroVAD.init_random(device="cpu"),
                               WeSpeaker.init_random(device="cpu"))
    want = pipe.diarize(load_audio(clips[1], 16000)[0], num_speakers=1)
    assert out == [{"start": round(s.start, 2), "end": round(s.end, 2), "speaker": int(s.speaker)}
                   for s in want]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run(capsys, "diarize", clips[1], "--random-weights", "--engine", "sortformer")


@pytest.mark.parametrize("model", ["wespeaker-resnet34", "campplus"])
def test_embed_speaker(capsys, clips, model):
    """WeSpeaker (the default) or CAM++ (``campplus``/``cam++`` in the name):
    the reference's keys, the first 8 values rounded to 4 places, and
    ``--compare``'s dot product."""
    from qwen3_asr_swift_tpu_torch.models.speaker import CampPlusSpeaker, WeSpeaker

    out = json.loads(run(capsys, "embed-speaker", clips[1], "--random-weights", "--model", model))
    m = (CampPlusSpeaker if model == "campplus" else WeSpeaker).init_random(device="cpu")
    emb = m.embed(load_audio(clips[1], 16000)[0])
    assert out == {"dim": len(emb), "norm": float(np.linalg.norm(emb)),
                   "embedding": [round(float(x), 4) for x in emb[:8]] + ["..."]}
    out = json.loads(run(capsys, "embed-speaker", clips[1], "--random-weights", "--model", model,
                         "--compare", clips[0]))
    other = m.embed(load_audio(clips[0], 16000)[0])
    assert out == {"similarity": float(np.dot(emb, other)), "dim": len(emb)}


def test_separate(capsys, clips, tmp_path):
    """Open-Unmix at the published widths (random): one WAV a stem at
    44.1 kHz, the stems' channel mean; a subset with ``--stems``."""
    from qwen3_asr_swift_tpu_torch.audio.io import read_wav, wav_bytes
    from qwen3_asr_swift_tpu_torch.models.separation import SourceSeparator

    prefix = str(tmp_path / "stem")
    out = json.loads(run(capsys, "separate", clips[0], "--random-weights", "--stems", "bass",
                         "vocals", "--output-prefix", prefix))
    assert out == {"bass": prefix + "_bass.wav", "vocals": prefix + "_vocals.wav"}
    audio, rate = read_wav(open(clips[0], "rb").read())
    model = SourceSeparator.init_random(device="cpu")
    want = model.separate(audio, rate, stems=["bass", "vocals"])
    heard, rate = read_wav(open(out["bass"], "rb").read())
    assert rate == 44100
    np.testing.assert_array_equal(heard, read_wav(wav_bytes(want["bass"].mean(axis=0),
                                                            44100))[0])


def test_translate(capsys):
    """``config_tiny()`` under ``--random-weights``: the reference's keys and
    its fixed source ids."""
    from qwen3_asr_swift_tpu_torch.models.translation import MADLADTranslator, config_tiny

    out = json.loads(run(capsys, "translate", "hello", "--random-weights"))
    want = MADLADTranslator.init_random(config_tiny(), device="cpu").translate_ids([5, 9, 13, 1],
                                                                                   max_new=8)
    assert out == {"note": "random weights — structural smoke only", "ids": want}


def _options(parser):
    """{subcommand: {dest: (option strings, default, nargs)}}."""
    out = {}
    for action in parser._subparsers._group_actions:
        for name, sub in action.choices.items():
            out[name] = {a.dest: (tuple(a.option_strings), a.default, a.nargs)
                         for a in sub._actions if a.dest != "help"}
    return out


def test_parser_has_the_reference_subcommands_and_options():
    port, ref = _options(cli.build_parser()), _options(jcli.build_parser())
    assert sorted(port) == sorted(PORTED)
    for name in PORTED:
        assert port[name] == ref[name], name
    top = {a.dest: a.default for a in cli.build_parser()._actions}
    assert top["device"] == "cuda" and "platform" not in top


def test_serve_wires_the_options(monkeypatch):
    seen = {}

    class FakeServer:
        def __init__(self, registry, **kw):
            seen.update(kw, registry=registry)

        async def serve_forever(self):
            seen["served"] = True

    monkeypatch.setattr("qwen3_asr_swift_tpu_torch.serving.server.SpeechServer", FakeServer)
    cli.main(["--device", "cpu", "serve", "--random-weights", "--scheduler", "slotpool",
              "--port", "0", "--slotpool-max-s", "8", "--bulk-nice", "5", "--decode-chunk", "4"])
    assert seen["served"] and seen["scheduler"] == "slotpool" and seen["slotpool_max_s"] == 8.0
    assert seen["bulk_nice"] == 5 and seen["port"] == 0
    model = seen["registry"]._loaders["asr"]()
    assert model.decode_chunk_tokens == 4 and model.device.type == "cpu"


def test_module_entry_defaults_to_the_card(clips):
    """``python -m`` runs the CLI; without ``--device`` it asks for the
    card, and on a machine without one that raises."""
    out = subprocess.run([sys.executable, "-m", "qwen3_asr_swift_tpu_torch.cli", "vad",
                          clips[0], "--random-weights"], capture_output=True, text=True,
                         cwd=REPO, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    if torch.cuda.is_available():
        assert out.returncode == 0, out.stderr
    else:
        assert out.returncode != 0 and "CUDA" in out.stderr
