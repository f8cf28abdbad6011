"""The PyTorch port's configuration, device rules and import hygiene.

- the port's copied config dataclasses equal the JAX package's, field by
  field, for every preset;
- entry points default to the first card, and asking for a CUDA device
  without one raises (no silent CPU);
- importing and running the port never imports jax nor any module of the
  JAX package;
- a CPU call leaves the kernels' launch counters at 0.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.qwen3_asr import config as jax_config
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("name", ["CONFIG_SMALL", "CONFIG_LARGE", "ENCODER_SMALL",
                                  "ENCODER_LARGE", "ENCODER_ALIGNER", "DECODER_SMALL",
                                  "DECODER_LARGE", "config_tiny"])
def test_presets_match_reference_field_by_field(name):
    ref, port = getattr(jax_config, name), getattr(port_config, name)
    if callable(ref):
        ref, port = ref(), port()
    assert _fields(port) == _fields(ref)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]


@pytest.mark.parametrize("cls", ["AudioEncoderConfig", "TextDecoderConfig", "Qwen3ASRConfig"])
def test_defaults_and_properties_match(cls):
    ref, port = getattr(jax_config, cls)(), getattr(port_config, cls)()
    assert _fields(port) == _fields(ref)
    for prop in ("chunk_frames", "tokens_per_chunk", "chunks_per_window", "window_tokens", "head_dim"):
        if hasattr(ref, prop):
            assert getattr(port, prop) == getattr(ref, prop)


def test_cuda_device_without_card_raises(monkeypatch):
    from qwen3_asr_swift_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device() == torch.device("cuda", 0)


def test_cuda_device_follows_set_device(monkeypatch):
    """``"cuda"`` and ``None`` name the current card, so a rank that called
    ``torch.cuda.set_device`` (``parallel.spawn``, ``torchrun``) keeps it;
    an explicit index is taken as it is and checked against the count."""
    from qwen3_asr_swift_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    for device in ("cuda", None, torch.device("cuda")):
        assert resolve_device(device) == torch.device("cuda", 2)
    assert resolve_device() == torch.device("cuda", 2)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="4 CUDA device"):
        resolve_device("cuda:4")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 5)
    with pytest.raises(RuntimeError, match="4 CUDA device"):
        resolve_device("cuda")


def test_model_refuses_cuda_without_card(monkeypatch):
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Qwen3ASR.init_random(config_tiny(), 0, device="cuda", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):   # the default device is the card
        Qwen3ASR.init_random(config_tiny(), 0, dtype=torch.float32)


def test_port_runs_without_importing_jax():
    code = textwrap.dedent("""
        import asyncio, http.client, json, os, sys, tempfile
        import numpy as np, torch
        from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
        from qwen3_asr_swift_tpu_torch.audio import load_audio, wav_bytes, write_wav
        from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions
        from qwen3_asr_swift_tpu_torch.serving import SlotPoolASR, SpeechServer, build_registry
        m = Qwen3ASR.init_random(config_tiny(), 0, device="cpu", dtype=torch.float32,
                                 audio_buckets_s=(8,), wire_dtype="dpcm4")
        clips = [np.zeros(8000, np.float32), np.ones(12000, np.float32) * 0.1]
        r = m.transcribe_batch(clips, max_tokens=3)
        assert len(r) == 2 and all(x.text for x in r), r
        r = m.transcribe_batch(clips, options=SamplingOptions(max_tokens=3, beam=2))
        assert len(r) == 2 and all(x.text for x in r), r
        r = m.transcribe_batch(clips, options=SamplingOptions(
            max_tokens=3, temperature=0.8, top_k=5, repetition_penalty=1.1), seed=3)
        assert len(r) == 2 and all(x.text for x in r), r
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "clip.wav")
            write_wav(path, clips[1][::2].copy(), 8000)
            audio, rate = load_audio(path, target_rate=16000)
        assert rate == 16000 and audio.shape == (12000,), (rate, audio.shape)
        group = SpeechServer(build_registry(m), port=0)
        slot = SpeechServer(build_registry(m), port=0, scheduler="slotpool", max_batch=2)
        slot._batchers[id(m)] = SlotPoolASR(m, slots=2, max_new=3, max_len=256)

        async def serve(srv):
            await srv.start()
            port = srv._server.sockets[0].getsockname()[1]

            def post():
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
                conn.request("POST", "/transcribe", wav_bytes(clips[1], 16000),
                             {"Content-Type": "audio/wav"})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())

            try:
                return await asyncio.get_running_loop().run_in_executor(None, post)
            finally:
                await srv.stop()

        for srv in (group, slot):
            status, body = asyncio.run(serve(srv))
            assert status == 200 and body["text"], (status, body)
        assert "jax" not in sys.modules, [k for k in sys.modules if k.startswith("jax")]
        ref = [k for k in sys.modules
               if k == "qwen3_asr_swift_tpu" or k.startswith("qwen3_asr_swift_tpu.")]
        assert not ref, ref
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_family_modules_run_without_importing_jax():
    """The wire codec, the loader, group-dot, Silero VAD, streaming ASR and
    the aligner run without importing jax or the JAX package."""
    code = textwrap.dedent("""
        import sys, tempfile
        import numpy as np, torch
        from qwen3_asr_swift_tpu_torch.audio import companding
        from qwen3_asr_swift_tpu_torch.core.params import (checkpoint_flat, init_random_params,
                                                            save_checkpoint)
        from qwen3_asr_swift_tpu_torch.models.qwen3_asr import (Qwen3ASR, Qwen3ForcedAligner,
                                                                StreamingASR, StreamingASRConfig,
                                                                config_tiny)
        from qwen3_asr_swift_tpu_torch.models.qwen3_asr import model as model_mod
        from qwen3_asr_swift_tpu_torch.models.silero_vad import SileroVAD, VADConfig
        from qwen3_asr_swift_tpu_torch.tokenizers.bpe import BPETokenizer, _bytes_to_unicode
        x = np.zeros((2, companding._NATIVE_MIN_SAMPLES), np.float32)
        companding.dpcm4_encode_np(x)
        cfg = config_tiny()
        m = Qwen3ASR.init_random(cfg, 0, device="cpu", dtype=torch.float32, quant_bits=4,
                                 audio_buckets_s=(8,), quant_compute="groupdot")
        assert m.transcribe(np.zeros(8000, np.float32), max_tokens=2).text
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(checkpoint_flat(*init_random_params(cfg, 0, 4)), d)
            model_mod.detect_config = lambda model_id: cfg
            m = Qwen3ASR.from_pretrained(d, device="cpu", dtype=torch.float32,
                                         audio_buckets_s=(8,))
        vad = SileroVAD.init_random(0, device="cpu")
        s = StreamingASR(m, vad, StreamingASRConfig(max_tokens=2, vad=VADConfig(onset=0.5,
                                                                                 offset=0.4)))
        audio = (0.3 * np.random.default_rng(0).standard_normal(32000)).astype(np.float32)
        s.push(audio)
        s.finish()
        enc = _bytes_to_unicode()
        tok = BPETokenizer({enc[b]: b for b in range(256)}, [])
        al = Qwen3ForcedAligner.init_random(device="cpu", dtype=torch.float32, tokenizer=tok)
        assert len(al.align(audio, "two words")) == 2
        assert "jax" not in sys.modules, [k for k in sys.modules if k.startswith("jax")]
        ref = [k for k in sys.modules
               if k == "qwen3_asr_swift_tpu" or k.startswith("qwen3_asr_swift_tpu.")]
        assert not ref, ref
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_conversational_paths_run_without_importing_jax():
    """Qwen3.5 chat (dense and packed), a tiny full-duplex PersonaPlex
    session (batch 2, int8 KV) and a ``VoicePipeline`` turn run without
    importing jax or the JAX package."""
    code = textwrap.dedent("""
        import shutil, sys, time
        import numpy as np, torch
        from qwen3_asr_swift_tpu_torch.cli import chat_tokenizer
        from qwen3_asr_swift_tpu_torch.models.chat import Qwen3Chat, config_tiny
        from qwen3_asr_swift_tpu_torch.models.personaplex import (PersonaPlex, PersonaSampling,
                                                                  config_tiny as pp_tiny)
        from qwen3_asr_swift_tpu_torch.pipeline import PipelineEventType, VoicePipeline
        chat = Qwen3Chat.init_random(config_tiny(), tokenizer=chat_tokenizer(), device="cpu")
        chat.max_new = 4
        reply = "".join(chat.chat([{"role": "user", "content": "hi"}]))
        import dataclasses
        wide = dataclasses.replace(config_tiny(), hidden_size=128, intermediate_size=256)
        assert len(Qwen3Chat.init_random(wide, quant_bits=4, device="cpu").generate_ids(
            [1, 2, 3], max_new=3)) == 3
        pp = PersonaPlex.init_random(pp_tiny(), 0, device="cpu")
        spf = pp.cfg.mimi.samples_per_frame
        s = pp.realtime_session(PersonaSampling(audio_temperature=0.0, text_temperature=0.0),
                                batch=2, kv_dtype=torch.int8)
        assert s.push_frames(np.zeros((2, spf), np.float32)).shape == (2, spf)
        if shutil.which("g++"):
            with VoicePipeline(stt=lambda a: "x", llm=chat, tts=lambda t: np.zeros(64, np.int16),
                               vad=lambda c: 0.0) as p:
                p.push_text("hi")
                deadline = time.time() + 60
                seen = []
                while time.time() < deadline and PipelineEventType.AUDIO_CHUNK not in seen:
                    seen += [e.type for e in p.drain_events(timeout=0.5)]
                assert PipelineEventType.RESPONSE_TEXT in seen, seen
        assert "jax" not in sys.modules, [k for k in sys.modules if k.startswith("jax")]
        ref = [k for k in sys.modules
               if k == "qwen3_asr_swift_tpu" or k.startswith("qwen3_asr_swift_tpu.")]
        assert not ref, ref
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_cosyvoice_and_vibevoice_run_without_importing_jax():
    """CosyVoice (synthesize, a stream chunk, a dialogue), VibeVoice
    (encode_voice, a voiced synthesize, generate_long), both converters on
    a checkpoint in memory, the CLI's ``vibevoice`` subcommands and
    ``/speak`` with ``engine`` under the slot pool run without importing
    jax or the JAX package."""
    code = textwrap.dedent("""
        import asyncio, contextlib, http.client, io, json, os, sys, tempfile, threading
        import numpy as np, torch
        from qwen3_asr_swift_tpu_torch import cli
        from qwen3_asr_swift_tpu_torch.models.cosyvoice import CosyVoiceTTS
        from qwen3_asr_swift_tpu_torch.models.cosyvoice import config_tiny as cosy_tiny
        from qwen3_asr_swift_tpu_torch.models.cosyvoice.convert import convert_flow
        from qwen3_asr_swift_tpu_torch.models.vibevoice import VibeVoiceTTS
        from qwen3_asr_swift_tpu_torch.models.vibevoice import config_tiny as vibe_tiny
        from qwen3_asr_swift_tpu_torch.models.vibevoice.convert import _Keys
        from qwen3_asr_swift_tpu_torch.serving import SpeechServer, build_registry
        cosy = CosyVoiceTTS.init_random(cosy_tiny(), device="cpu")
        assert len(cosy.synthesize("hi").samples) > 0
        assert len(next(cosy.synthesize_stream("hi", chunk_tokens=2)).samples) > 0
        assert len(cosy.synthesize_dialogue("A: hi\\nB: yo").samples) > 0
        vibe = VibeVoiceTTS.init_random(vibe_tiny(), device="cpu")
        with tempfile.TemporaryDirectory() as d:
            voice = str(vibe.encode_voice(np.zeros(48, np.float32), "hi", os.path.join(d, "v.npz")))
            assert len(vibe.synthesize("hi", voice=voice, max_frames=2).samples) > 0
            assert len(vibe.generate_long("One. Two.", max_chars_per_chunk=4,
                                          max_frames=2).samples) > 0
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["--device", "cpu", "vibevoice", "hi", "--random-weights", "--output",
                          os.path.join(d, "o.wav")])
                cli.main(["--device", "cpu", "vibevoice-encode-voice", os.path.join(d, "o.wav"),
                          "--random-weights", "--output", os.path.join(d, "c.npz")])
        w = np.ones((6, 1, 3), np.float32)
        assert _Keys({"a.conv.conv.weight": w}).conv("a")["kernel"].shape == (3, 1, 6)
        assert callable(convert_flow)
        registry = build_registry()
        registry.register_instance("tts:cosyvoice", cosy)
        server = SpeechServer(registry, port=0, scheduler="slotpool")
        loop = asyncio.new_event_loop()
        t = threading.Thread(target=loop.run_forever, daemon=True)
        t.start()
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(timeout=30)
        conn = http.client.HTTPConnection("127.0.0.1", server._server.sockets[0].getsockname()[1],
                                          timeout=120)
        conn.request("POST", "/speak", body=json.dumps({"text": "hi", "engine": "cosyvoice"}))
        assert conn.getresponse().status == 200
        conn.close()
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=30)
        assert "jax" not in sys.modules, [k for k in sys.modules if k.startswith("jax")]
        ref = [k for k in sys.modules
               if k == "qwen3_asr_swift_tpu" or k.startswith("qwen3_asr_swift_tpu.")]
        assert not ref, ref
        print("OK")
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_cpu_call_leaves_launch_counters_at_zero(monkeypatch):
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
    from qwen3_asr_swift_tpu_torch.ops import quant
    from qwen3_asr_swift_tpu_torch.ops.attention_int8 import K3_LAUNCHES
    from qwen3_asr_swift_tpu_torch.ops.quant import K1_LAUNCHES, K2_LAUNCHES

    cfg = config_tiny()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2,
        head_dim=32), encoder=dataclasses.replace(cfg.encoder, output_dim=128))
    m = Qwen3ASR.init_random(cfg, 0, device="cpu", dtype=torch.float32, quant_bits=4,
                             kv_dtype=torch.int8, audio_buckets_s=(8,))
    before = (K1_LAUNCHES.value, K2_LAUNCHES.value, K3_LAUNCHES.value)
    m.transcribe_batch([np.zeros(16000, np.float32)], max_tokens=3)
    monkeypatch.setattr(quant, "KERNEL", "plane")
    m.transcribe_batch([np.zeros(16000, np.float32)], max_tokens=3)
    assert (K1_LAUNCHES.value, K2_LAUNCHES.value, K3_LAUNCHES.value) == before
