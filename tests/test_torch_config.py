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
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device() == torch.device("cuda", 0)


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
