"""The port's Qwen3-TTS against the JAX package's, at the tiny config.

Both packages take the same numpy weights (drawn by the port's
initialisers, carried across by ``params_from_jax``) and the same byte
tokenizer, in fp32:

- M-RoPE, the talker's prefill hidden states and logits, a talker step's
  logits and the code predictor's group logits within 1e-5 of max |ref|;
- greedy ``generate_codes`` and ``synthesize_batch`` codes identical to the
  reference's, dense and packed 4-bit under ``quant_compute="fused"`` (the
  reference takes ``quant_matmul_xla`` on the CPU, K1's plain function);
- under ``"groupdot"`` every product of the port's frame loop within 1e-5
  of the reference's ``quant_matmul_groupdot`` on the same input, call by
  call. Whole-model group-dot codes are NOT compared: group-dot quantizes
  each activation group to int8, which turns rounding noise into code
  flips (ROADMAP §3);
- both prompt builders equal to the reference's;
- the codec decoder stage by stage within 1e-5 (each stage fed the
  reference's input), and whole: the reference's waveform within 1e-3 of
  max |ref| of the port's float64 decode, the port's within 1e-3 of the
  reference's and no farther from the float64 decode than twice the
  reference's distance. A whole-decoder bound of 1e-4 of max |ref| cannot
  hold for any fp32 implementation here: the random decoder amplifies fp32
  rounding (values reach ~24 before the final conv and the ±1 clip), and
  the reference itself lies ~2.5e-4 from the float64 decode (ROADMAP §3);
- ``decode_frames`` and ``decode_stream`` against ``decode``;
- temperature sampling by properties (range, suppressed specials, seeds);
- the checkpoint round trip through ``from_pretrained(dir)``;
- the Kaldi fbank, ``speaker_embed`` and ``codec_encode``, and a voice
  clone's codes, against the reference's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.qwen3_tts import Qwen3TTS as JaxTTS
from qwen3_asr_swift_tpu.models.qwen3_tts import TTSSamplingConfig as JaxSampling
from qwen3_asr_swift_tpu.models.qwen3_tts import code_predictor as jcp
from qwen3_asr_swift_tpu.models.qwen3_tts import codec as jcodec
from qwen3_asr_swift_tpu.models.qwen3_tts import talker as jtalker
from qwen3_asr_swift_tpu.models.qwen3_tts import voice_clone as jvc
from qwen3_asr_swift_tpu.ops import fbank as jfbank
from qwen3_asr_swift_tpu.ops import quant as jq
from qwen3_asr_swift_tpu.ops.kv_cache import init_cache as jax_init_cache
from qwen3_asr_swift_tpu.ops.rope import rope_angles as jax_rope_angles
from qwen3_asr_swift_tpu.tokenizers.bpe import BPETokenizer as JaxBPE
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax, save_checkpoint
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import (CodecTokens, Qwen3TTS,
                                                        TTSSamplingConfig, config_tiny)
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import code_predictor as pcp
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import codec as pcodec
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import convert as pconvert
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import talker as ptalker
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import voice_clone as pvc
from qwen3_asr_swift_tpu_torch.ops import fbank as pfbank
from qwen3_asr_swift_tpu_torch.ops import quant as pq
from qwen3_asr_swift_tpu_torch.ops.rope import rope_angles
from qwen3_asr_swift_tpu_torch.tokenizers.bpe import BPETokenizer, _bytes_to_unicode

CFG = config_tiny()
TOL = 1e-5
FRAMES = 12
GREEDY = TTSSamplingConfig(temperature=0.0, max_frames=FRAMES)
JGREEDY = JaxSampling(temperature=0.0, max_frames=FRAMES)
TEXTS = ["hello world", "a", ""]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The frame loops are chains of small ops: with several test workers
    on the host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def wide_cfg():
    """The reference's quantized-frame-loop config: widths of 128, so the
    talker's and the code predictor's linears pack (min_dim 128)."""
    t = CFG
    return dataclasses.replace(
        t, talker=dataclasses.replace(t.talker, hidden_size=128, intermediate_size=256,
                                      num_heads=4, num_kv_heads=4, head_dim=32,
                                      mrope_sections=(8, 4, 4)),
        code_predictor=dataclasses.replace(t.code_predictor, hidden_size=128,
                                           intermediate_size=256, num_heads=4, num_kv_heads=4,
                                           head_dim=32, embedding_dim=128))


def byte_vocab():
    b2u = _bytes_to_unicode()
    return {b2u[b]: b for b in range(256)}


def weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return (ptalker.init_talker_params(rng, cfg.talker), pcp.init_cp_params(rng, cfg.code_predictor),
            pcodec.init_codec_params(rng, cfg.codec), pvc.init_codec_encoder(rng, cfg.codec),
            pvc.init_speaker_encoder(rng))


def pair(cfg, seed=0, **kw):
    """(port model, reference model) on the same numpy weights."""
    t, c, k, enc, spk = weights(cfg, seed)
    jkw = dict(kw)
    if jkw.get("quant_compute") == "fused":
        jkw["quant_compute"] = "packed"
    port = Qwen3TTS(cfg, t, c, k, device="cpu", dtype=torch.float32,
                    tokenizer=BPETokenizer(byte_vocab(), []), encoder_params=enc,
                    speaker_encoder_params=spk, **kw)
    ref = JaxTTS(cfg, t, c, k, dtype=jnp.float32, tokenizer=JaxBPE(byte_vocab(), []),
                 encoder_params=enc, speaker_encoder_params=spk, **jkw)
    return port, ref


@pytest.fixture(scope="module")
def dense():
    return pair(CFG, quant_compute="fused")


@pytest.fixture(scope="module")
def packed():
    return pair(wide_cfg(), quant_bits=4, quant_compute="fused")


def close(got, want, tol=TOL, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} > {tol:g}"


# --------------------------------------------------------------------------- #
# modules


def test_mrope_equal_streams_match_standard_rope():
    pos = torch.arange(6)[None]
    cos_m, sin_m = ptalker.mrope_angles(pos[None].expand(3, 1, 6), 16, (4, 2, 2), 1e6)
    cos_s, sin_s = rope_angles(pos, 16, 1e6)
    torch.testing.assert_close(cos_m, cos_s, rtol=0, atol=1e-6)
    torch.testing.assert_close(sin_m, sin_s, rtol=0, atol=1e-6)
    close(cos_m, np.asarray(jax_rope_angles(jnp.arange(6)[None], 16, 1e6)[0]), 1e-6)


def test_mrope_sections_use_their_stream():
    rng = np.random.default_rng(0)
    pos3 = rng.integers(0, 5000, (3, 2, 5)).astype(np.int32)
    cos, sin = ptalker.mrope_angles(torch.from_numpy(pos3), 16, (4, 2, 2), 10.0)
    jcos, jsin = jtalker.mrope_angles(jnp.asarray(pos3), 16, (4, 2, 2), 10.0)
    close(cos, jcos, 1e-6, "cos")
    close(sin, jsin, 1e-6, "sin")
    # the first 4 frequencies follow stream 0 only
    zero_t = pos3.copy()
    zero_t[0] = 0
    c0, _ = ptalker.mrope_angles(torch.from_numpy(zero_t), 16, (4, 2, 2), 10.0)
    assert torch.allclose(c0[..., :4], torch.ones(()), atol=1e-6)


@pytest.mark.parametrize("which", ["dense", "packed"])
def test_talker_prefill_and_step_match_reference(which, dense, packed):
    port, ref = dense if which == "dense" else packed
    tcfg = port.cfg.talker
    rng = np.random.default_rng(1)
    b, t = 2, 7
    embeds = (0.1 * rng.standard_normal((b, t, tcfg.hidden_size))).astype(np.float32)
    valid = np.ones((b, t), bool)
    valid[1, 5:] = False
    cache = ptalker.make_talker_cache(tcfg, b, t + 3, torch.float32, device="cpu")
    logits, hidden, cache = ptalker.talker_prefill(port.talker_params, tcfg, torch.from_numpy(embeds),
                                                   torch.from_numpy(valid), cache)
    jcache = jax_init_cache(tcfg.num_layers, b, tcfg.num_kv_heads, t + 3, tcfg.head_dim,
                            jnp.float32)
    jl, jh, jcache = jax.jit(jtalker.talker_prefill, static_argnums=1)(
        ref.talker_params, tcfg, jnp.asarray(embeds), jnp.asarray(valid), jcache)
    jstep = jax.jit(jtalker.talker_step, static_argnums=1)
    close(hidden, jh, what="prefill hidden")
    close(logits, jl, what="prefill logits")
    for step in range(2):
        x = (0.1 * rng.standard_normal((b, 1, tcfg.hidden_size))).astype(np.float32)
        logits, hidden, cache = ptalker.talker_step(port.talker_params, tcfg, torch.from_numpy(x),
                                                    cache)
        jl, jh, jcache = jstep(ref.talker_params, tcfg, jnp.asarray(x), jcache)
        close(logits, jl, what=f"step {step} logits")
        close(hidden, jh, what=f"step {step} hidden")


@pytest.mark.parametrize("which", ["dense", "packed"])
def test_code_predictor_matches_reference(which, dense, packed):
    port, ref = dense if which == "dense" else packed
    cpcfg = port.cfg.code_predictor
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((3, cpcfg.embedding_dim)).astype(np.float32)
    emb = rng.standard_normal((3, cpcfg.embedding_dim)).astype(np.float32)
    logits0, _, _ = pcp.cp_prefill(port.cp_params, cpcfg, torch.from_numpy(hidden),
                                   torch.from_numpy(emb))
    k = jnp.zeros((cpcfg.num_layers, 3, cpcfg.num_kv_heads, jcp.MAX_CP_LEN, cpcfg.head_dim))
    normed, _, _ = jax.jit(jcp._cp_forward, static_argnums=1)(
        ref.cp_params, cpcfg, jnp.stack([hidden, emb], axis=1),
        jnp.broadcast_to(jnp.arange(2)[None], (3, 2)), k, k, jnp.asarray(0), jnp.asarray(2))
    close(logits0, normed[:, 1] @ ref.cp_params["lm_heads"][0], what="group 0 logits")
    codes = pcp.predict_codebooks(port.cp_params, cpcfg, torch.from_numpy(hidden),
                                  torch.from_numpy(emb))
    want = jax.jit(jcp.predict_codebooks, static_argnums=1)(
        ref.cp_params, cpcfg, jnp.asarray(hidden), jnp.asarray(emb), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    close(pcp.embed_all_groups(port.cp_params, cpcfg, codes),
          jcp.embed_all_groups(ref.cp_params, cpcfg, want), what="group embeddings")


def _codec_stages(cfg, m):
    """Each stage of the decoder as (name, fn(params, x)), with ``m`` the
    module (the port's or the reference's)."""
    stages = [("rvq", lambda p, x: m.rvq_decode(p, cfg, x)),
              ("pre_conv", lambda p, x: m.causal_conv1d(x, p["pre_conv"])),
              ("transformer", lambda p, x: m._pre_transformer(p, cfg, x))]
    for i, r in enumerate(cfg.upsampling_ratios):
        stages.append((f"upsample {i}", lambda p, x, i=i, r=r: m.convnext_block(
            m.causal_transpose_conv1d(x, p["pre_upsample"][i]["upsample"], r),
            p["pre_upsample"][i]["convnext"])))
    stages.append(("input_conv", lambda p, x: m.causal_conv1d(x, p["input_conv"])))
    for i, r in enumerate(cfg.upsample_rates):
        def block(p, x, i=i, r=r):
            blk = p["blocks"][i]
            h = m.causal_transpose_conv1d(m.snake_beta(x, blk["snake"]), blk["upsample"], r)
            for u in blk["units"]:
                v = m.snake_beta(m.causal_conv1d(m.snake_beta(h, u["snake1"]), u["conv1"]),
                                 u["snake2"])
                h = h + m.causal_conv1d(v, u["conv2"])
            return h
        stages.append((f"block {i}", block))
    stages.append(("final", lambda p, x: m.causal_conv1d(m.snake_beta(x, p["final_snake"]),
                                                         p["final_conv"])))
    return stages


@pytest.fixture(scope="module")
def codec_case(dense):
    port, ref = dense
    codes = np.random.default_rng(3).integers(0, 2048, (1, 16, 9))
    return port, ref, codes


def test_codec_decode_stages_match_reference(codec_case):
    port, ref, codes = codec_case
    cfg = port.cfg.codec
    pst, jst = _codec_stages(cfg, pcodec), _codec_stages(cfg, jcodec)
    x = codes
    for (name, pf), (_, jf) in zip(pst, jst):
        want = jax.jit(jf)(ref.codec.params, jnp.asarray(x))
        got = pf(port.codec.params, torch.from_numpy(np.asarray(x)))
        close(got, want, what=name)
        x = np.asarray(want)


def test_codec_decode_as_accurate_as_reference(codec_case):
    port, ref, codes = codec_case
    got = pcodec.codec_decode(port.codec.params, port.cfg.codec, torch.from_numpy(codes)).numpy()
    want = np.asarray(jax.jit(jcodec.codec_decode, static_argnums=1)(
        ref.codec.params, port.cfg.codec, jnp.asarray(codes)))
    p64 = params_from_jax(port.codec.params, "cpu", torch.float64)
    exact = pcodec.codec_decode(p64, port.cfg.codec, torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (1, 9 * 1920)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    ref_err, port_err = np.abs(want - exact).max(), np.abs(got - exact).max()
    diff = np.abs(got - want).max()
    print(f"codec decode: reference {ref_err / scale:.3g}, port {port_err / scale:.3g} of max "
          f"|ref| from the float64 decode; port vs reference {diff / scale:.3g}")
    # the float64 decode is the port's own, so it vouches for the port only
    # if the reference lands near it too (~2.5e-4 of max |ref|, ROADMAP §3),
    # and the two fp32 waveforms are held to each other directly
    assert ref_err <= 1e-3 * scale, (ref_err, scale)
    assert diff <= 1e-3 * scale, (diff, scale)
    assert port_err <= 2 * ref_err + 1e-6, (port_err, ref_err)


def test_decode_frames_and_stream_match_decode(dense):
    port, _ = dense
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 2048, (16, 11))
    full = port.codec.decode(codes)
    assert full.shape == (11 * 1920,)
    padded = np.zeros((1, 16, 16), np.int64)       # as the frame loop leaves them
    padded[0, :11] = codes.T
    frames = port.codec.decode_frames(torch.from_numpy(padded), 11)[0]
    np.testing.assert_array_equal(frames, full)   # the same bucket of 16 frames
    streamed = np.concatenate(list(port.codec.decode_stream(codes, chunk=4, left_context=11)))
    # each chunk decodes its whole prefix: the same causal graph at another
    # length, so only fp32 sums in another order differ
    err = np.abs(streamed - full).max()
    assert streamed.shape == full.shape and err <= 5e-4, err
    first = next(port.codec.decode_stream(codes, chunk=4, left_context=0))
    np.testing.assert_allclose(first, full[:4 * 1920], atol=5e-4)


# --------------------------------------------------------------------------- #
# prompts


@pytest.mark.parametrize("text", TEXTS)
def test_prompt_builders_match_reference(dense, text):
    port, ref = dense
    pf, tf, pad_f, p_len, t_len, p_block, t_block = port._build_prompt_fused(text, "english", None)
    jpf, jtf, jpad, *jlens = ref._build_prompt_fused(text, "english", None)
    assert [p_len, t_len, p_block, t_block] == list(jlens)
    close(pf, jpf, what="fused prefill")
    close(tf, jtf, what="fused trailing")
    close(pad_f, jpad, what="fused tts_pad")
    pe, te, pad_e = port._build_prompt_embeds(text, "german", None, "speak slowly")
    jpe, jte, jpad_e = ref._build_prompt_embeds(text, "german", None, "speak slowly")
    close(pe, jpe, what="eager prefill")
    close(te, jte, what="eager trailing")
    close(pad_e, jpad_e, what="eager tts_pad")


def test_speaker_prefix_matches_reference(dense):
    port, ref = dense
    port.speakers = ref.speakers = {"vivian": 2151}
    try:
        assert port._codec_prefix_ids("fr", "Vivian") == ref._codec_prefix_ids("fr", "Vivian")
        pf, *_ = port._build_prompt_fused("hey", "english", "vivian")
        jpf, *_ = ref._build_prompt_fused("hey", "english", "vivian")
        close(pf, jpf, what="speaker prefill")
    finally:
        port.speakers, ref.speakers = {}, {}


def test_out_of_vocab_text_raises():
    cfg = dataclasses.replace(CFG, talker=dataclasses.replace(CFG.talker, text_vocab_size=100))
    t, c, k, _, _ = weights(cfg)
    m = Qwen3TTS(cfg, t, c, k, device="cpu", dtype=torch.float32,
                 tokenizer=BPETokenizer(byte_vocab(), []))
    with pytest.raises(ValueError, match="text_vocab_size"):
        m.generate_codes("zzz", sampling=GREEDY)


def test_unknown_quant_compute_raises():
    t, c, k, _, _ = weights(CFG)
    with pytest.raises(ValueError, match="quant_compute"):
        Qwen3TTS(CFG, t, c, k, device="cpu", quant_compute="packed")


# --------------------------------------------------------------------------- #
# the frame loop


@pytest.mark.parametrize("which", ["dense", "packed"])
def test_greedy_codes_match_reference(which, dense, packed):
    port, ref = dense if which == "dense" else packed
    for text in TEXTS:
        got, n = port.generate_codes(text, sampling=GREEDY)
        want, jn = ref.generate_codes(text, sampling=JGREEDY)
        assert n == jn and n > 0, (text, n, jn)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["dense", "packed"])
def test_batch_codes_match_reference(which, dense, packed):
    port, ref = dense if which == "dense" else packed
    texts = ["hi there", "a much longer sentence to say"]
    seen = {}

    def capture(model, key):
        decode = model.codec.decode_frames

        def grab(codes, n):
            seen[key] = np.asarray(codes if not isinstance(codes, torch.Tensor)
                                   else codes.cpu().numpy())[:, :n]
            return decode(codes, n)
        return grab

    port.codec.decode_frames = capture(port, "port")
    ref.codec.decode_frames = capture(ref, "ref")
    try:
        got = port.synthesize_batch(texts, sampling=GREEDY)
        want = ref.synthesize_batch(texts, sampling=JGREEDY)
    finally:
        del port.codec.decode_frames, ref.codec.decode_frames
    np.testing.assert_array_equal(seen["port"], seen["ref"])
    assert [len(c.samples) for c in got] == [len(c.samples) for c in want]


def test_packed_model_runs_k1_wrapper_and_fuses(packed, monkeypatch):
    port, _ = packed
    l0 = port.talker_params["layers"][0]
    assert "codes" in l0["qkv_proj"] and "codes" in l0["mlp"]["gate_up_proj"]
    assert "codes" in port.talker_params["codec_head"]
    assert "codes" in port.cp_params["layers"][0]["qkv_proj"]
    calls = []
    k1 = pq.quant_matmul_cuda
    monkeypatch.setattr(pq, "quant_matmul_cuda", lambda x, p: calls.append(x.shape) or k1(x, p))
    port.generate_codes("hi", sampling=dataclasses.replace(GREEDY, max_frames=2))
    assert calls and max(int(np.prod(s[:-1])) for s in calls) <= pq.KERNEL_MAX_ROWS
    # 2 frames: prompt (fc2 twice) + prefill (2 layers × 4 + head) + 2 CP
    # chains (15 forwards × 2 layers × 4) + 1 talker step (2 × 4 + head)
    assert len(calls) == 2 + 9 + 2 * 15 * 8 + 9


def test_groupdot_products_match_reference_call_by_call():
    """Every group-dot product the port's frame loop computes equals the
    reference's ``quant_matmul_groupdot`` on the same input within 1e-5.
    Whole-model codes are not compared: the int8 activation quantizer
    turns fp32 rounding noise into code flips (ROADMAP §3)."""
    port, ref = pair(wide_cfg(), quant_bits=4, quant_compute="groupdot")
    l0, jl0 = port.talker_params["layers"][0], ref.talker_params["layers"][0]
    for name in ("gcodes", "gscales", "gbiases"):
        np.testing.assert_array_equal(l0["qkv_proj"][name].numpy(),
                                      np.asarray(jl0["qkv_proj"][name]))
    calls = []
    gd, jgd = pq.quant_matmul_groupdot, jax.jit(jq.quant_matmul_groupdot)

    def record(x, p):
        y = gd(x, p)
        calls.append((x.clone(), {k: v.numpy() for k, v in p.items()}, y.clone()))
        return y

    pq.quant_matmul_groupdot = record
    try:
        port.generate_codes("group dot", sampling=dataclasses.replace(GREEDY, max_frames=2))
    finally:
        pq.quant_matmul_groupdot = gd
    assert len(calls) > 100
    for x, p, y in calls:
        close(y, jgd(jnp.asarray(x.numpy()), p), what="groupdot product")


def test_temperature_sampling_properties(dense):
    port, _ = dense
    s = TTSSamplingConfig(temperature=0.9, top_k=50, max_frames=FRAMES)
    a, n = port.generate_codes("sample me", sampling=s, seed=5)
    b, nb = port.generate_codes("sample me", sampling=s, seed=5)
    c, _ = port.generate_codes("sample me", sampling=s, seed=6)
    assert n == nb and np.array_equal(a, b)
    assert not np.array_equal(a, c[:, :a.shape[1]]) or a.shape != c.shape
    assert ((a[0] < 2048) | (a[0] == CodecTokens.EOS)).all()
    assert (a[1:] >= 0).all() and (a[1:] < CFG.code_predictor.vocab_size).all()
    # the suppressed special range never wins, even when it dominates
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts.model import sample_code0
    lg = torch.zeros((2, 3072))
    lg[:, 2048:] = 100.0
    ring = torch.full((2, 4), -1, dtype=torch.int64)
    for temp in (0.0, 0.9):
        got = sample_code0(lg, ring, TTSSamplingConfig(temperature=temp, top_k=0),
                           torch.Generator().manual_seed(0))
        assert (got == CodecTokens.EOS).all()


def test_repetition_penalty_matches_reference_sampler():
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts.model import sample_code0
    rng = np.random.default_rng(7)
    lg = rng.standard_normal((3, 3072)).astype(np.float32)
    ring = rng.integers(-1, 40, (3, 8))
    ring[:, ::3] = -1
    # greedy with a strong penalty and top-k over the reference's formula
    s = TTSSamplingConfig(temperature=0.0, top_k=5, repetition_penalty=3.0)
    got = sample_code0(torch.from_numpy(lg), torch.from_numpy(ring), s, None)
    ids = np.arange(3072)
    want_lg = np.where((ids >= 2048) & (ids != CodecTokens.EOS), -1e9, lg)
    for r in range(3):
        seen = np.zeros(3072, bool)
        seen[ring[r][ring[r] >= 0]] = True
        want_lg[r] = np.where(seen, np.where(want_lg[r] > 0, want_lg[r] / 3.0, want_lg[r] * 3.0),
                              want_lg[r])
    np.testing.assert_array_equal(got.numpy(), want_lg.argmax(-1))


def test_synthesize_and_stream(dense):
    port, ref = dense
    out = port.synthesize("hello", sampling=GREEDY)
    codes, n = port.generate_codes("hello", sampling=GREEDY)
    assert out.sample_rate == 24000 and len(out.samples) == n * 1920
    assert np.isfinite(out.samples).all()
    chunks = list(port.synthesize_stream("hello", sampling=GREEDY))
    assert sum(len(c.samples) for c in chunks) == n * 1920
    assert port.synthesize_batch([]) == []


# --------------------------------------------------------------------------- #
# checkpoints, fbank, voice cloning


def test_checkpoint_round_trip(tmp_path, dense, monkeypatch):
    from test_qwen3_tts_convert import (_export_conv, _export_convnext, _export_convt,
                                        _export_layers, _export_lin, _export_snake)

    port, _ = dense
    talker, cp, codec, _, _ = weights(CFG)
    flat = {"talker.model.text_embedding.weight": talker["text_embedding"],
            "talker.model.codec_embedding.weight": talker["codec_embedding"],
            "talker.model.norm.weight": talker["norm"]["weight"],
            "talker.code_predictor.model.norm.weight": cp["norm"]["weight"]}
    _export_lin(flat, "talker.text_projection.linear_fc1", talker["text_projection"]["fc1"])
    _export_lin(flat, "talker.text_projection.linear_fc2", talker["text_projection"]["fc2"])
    _export_lin(flat, "talker.codec_head", talker["codec_head"])
    _export_layers(flat, "talker.model", talker["layers"])
    for i in range(CFG.code_predictor.num_code_groups - 1):
        flat[f"talker.code_predictor.model.codec_embedding.{i}.weight"] = cp["group_embeds"][i]
        flat[f"talker.code_predictor.lm_head.{i}.weight"] = np.ascontiguousarray(cp["lm_heads"][i].T)
    _export_layers(flat, "talker.code_predictor.model", cp["layers"])
    q = "decoder.quantizer"
    flat[f"{q}.rvq_first.vq.layers.0._codebook.embedding.weight"] = codec["rvq_first"]["codebook"][0]
    _export_conv(flat, f"{q}.rvq_first.output_proj", codec["rvq_first"]["output_proj"])
    for i in range(CFG.codec.num_quantizers - 1):
        flat[f"{q}.rvq_rest.vq.layers.{i}._codebook.embedding.weight"] = \
            codec["rvq_rest"]["codebook"][i]
    _export_conv(flat, f"{q}.rvq_rest.output_proj", codec["rvq_rest"]["output_proj"])
    _export_conv(flat, "decoder.pre_conv.conv", codec["pre_conv"])
    tr = codec["transformer"]
    _export_lin(flat, "decoder.pre_transformer.input_proj", tr["input_proj"])
    _export_lin(flat, "decoder.pre_transformer.output_proj", tr["output_proj"])
    flat["decoder.pre_transformer.norm.weight"] = tr["norm"]["weight"]
    for i, lp in enumerate(tr["layers"]):
        p = f"decoder.pre_transformer.layers.{i}"
        flat[f"{p}.norm1.weight"], flat[f"{p}.norm2.weight"] = lp["norm1"]["weight"], lp["norm2"]["weight"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _export_lin(flat, f"{p}.self_attn.{n}", lp[n])
        for n in ("gate_proj", "up_proj", "down_proj"):
            _export_lin(flat, f"{p}.mlp.{n}", lp[n])
        flat[f"{p}.self_attn_layer_scale.scale"] = lp["attn_scale"]
        flat[f"{p}.mlp_layer_scale.scale"] = lp["mlp_scale"]
    for u in range(2):
        _export_convt(flat, f"decoder.upsample.{u}.0.conv", codec["pre_upsample"][u]["upsample"])
        _export_convnext(flat, f"decoder.upsample.{u}.1", codec["pre_upsample"][u]["convnext"])
    _export_conv(flat, "decoder.decoder.0.conv", codec["input_conv"])
    for bi, block in enumerate(codec["blocks"], start=1):
        p = f"decoder.decoder.{bi}"
        _export_snake(flat, f"{p}.block.0", block["snake"])
        _export_convt(flat, f"{p}.block.1.conv", block["upsample"])
        for ui, unit in enumerate(block["units"]):
            base = f"{p}.block.{2 + ui}"
            _export_snake(flat, f"{base}.snake1", unit["snake1"])
            _export_conv(flat, f"{base}.conv1.conv", unit["conv1"])
            _export_snake(flat, f"{base}.snake2", unit["snake2"])
            _export_conv(flat, f"{base}.conv2.conv", unit["conv2"])
    _export_snake(flat, "decoder.decoder.5", codec["final_snake"])
    _export_conv(flat, "decoder.decoder.6.conv", codec["final_conv"])

    d = tmp_path / "Qwen3-TTS-0.6B-test"
    save_checkpoint({k: np.ascontiguousarray(v) for k, v in flat.items()}, d,
                    dtype_of=lambda name: torch.float32)
    (d / "vocab.json").write_text(json.dumps(byte_vocab()))
    (d / "merges.txt").write_text("#version: 0.2\n")
    (d / "config.json").write_text(json.dumps({"talker_config": {"speaker_ids": {"Vivian": 2151}}}))
    # the directory's name picks CONFIG_06B; these weights are the tiny config's
    monkeypatch.setattr(pconvert, "detect_tts_config", lambda *a: CFG)
    loaded = Qwen3TTS.from_pretrained(str(d), device="cpu", dtype=torch.float32,
                                      quant_compute="fused")
    assert loaded.speakers == {"vivian": 2151}
    got, n = loaded.generate_codes("hello world", sampling=GREEDY)
    want, wn = port.generate_codes("hello world", sampling=GREEDY)
    assert n == wn
    np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError, match="offline mode: no cached snapshot"):
        Qwen3TTS.from_pretrained("aufklarer/Qwen3-TTS-1.7B-MLX-4bit", device="cpu",
                                 cache_dir=str(tmp_path / "cache"), offline_mode=True)


def test_fbank_matches_reference():
    audio = (0.1 * np.random.default_rng(8).standard_normal(16000)).astype(np.float32)
    close(pfbank.kaldi_fbank(torch.from_numpy(audio)), jfbank.kaldi_fbank(jnp.asarray(audio)),
          what="fbank")
    assert pfbank.kaldi_fbank(torch.zeros(100)).shape == (0, 80)


def test_speaker_embed_and_codec_encode_match_reference(dense):
    port, ref = dense
    rng = np.random.default_rng(9)
    audio16 = (0.1 * rng.standard_normal(24000)).astype(np.float32)
    got = port.speaker_embedding(audio16)
    close(got, jax.jit(jvc.speaker_embed)(ref.speaker_encoder_params, audio16), what="x-vector")
    assert abs(np.linalg.norm(got) - 1.0) < 1e-5
    wave = (0.1 * rng.standard_normal(24000 * 2)).astype(np.float32)
    codes = pvc.codec_encode(port.encoder_params, port.codec.params, CFG.codec, torch.from_numpy(wave))
    want = jax.jit(jvc.codec_encode, static_argnums=2)(ref.encoder_params, ref.codec.params,
                                                       CFG.codec, jnp.asarray(wave))
    assert codes.shape == (25, 16)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))


def test_voice_clone_codes_match_reference(dense):
    port, ref = dense
    wave = (0.1 * np.random.default_rng(10).standard_normal(24000)).astype(np.float32)
    for m in (port, ref):
        m.register_voice_clone("me", wave, transcript="ref words", max_frames=6)
    try:
        np.testing.assert_array_equal(port.ref_cache.get("me")[0], ref.ref_cache.get("me")[0])
        got, n = port.generate_codes("cloned", speaker="me", sampling=GREEDY)
        want, jn = ref.generate_codes("cloned", speaker="me", sampling=JGREEDY)
        assert n == jn
        np.testing.assert_array_equal(got, want)
    finally:
        port.ref_cache = pvc.ReferenceAudioCache()
        ref.ref_cache = jvc.ReferenceAudioCache()


# --------------------------------------------------------------------------- #
# the tree helpers the TTS load path uses


def _tree_np(rng):
    return {"a": {"kernel": rng.standard_normal((128, 256)).astype(np.float32),
                  "bias": rng.standard_normal(256).astype(np.float32)},
            "small": {"kernel": rng.standard_normal((64, 128)).astype(np.float32)},
            "layers": [{"q": {"kernel": rng.standard_normal((192, 128)).astype(np.float32)}}],
            "embed_tokens": rng.standard_normal((40, 128)).astype(np.float32),
            "norm": np.ones(7, np.float32)}


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_tree_matches_reference(bits):
    tree = _tree_np(np.random.default_rng(bits))
    got = pq.quantize_tree(params_from_jax(tree, "cpu", torch.float32), bits)
    want = jq.quantize_tree(tree, bits)
    for path in (("a",), ("layers", 0, "q"), ("embed_tokens",)):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_array_equal(g["codes"].numpy().view(np.uint32), np.asarray(w["codes"]))
        np.testing.assert_array_equal(g["scales"].numpy(), np.asarray(w["scales"]))
        np.testing.assert_array_equal(g["biases"].numpy(), np.asarray(w["biases"]))
    np.testing.assert_array_equal(got["a"]["bias"].numpy(), want["a"]["bias"])
    assert "kernel" in got["small"] and "kernel" in want["small"]   # 64 < min_dim


def test_cast_tree_and_split_linear_match_reference():
    from qwen3_asr_swift_tpu.ops import nn as jnn
    from qwen3_asr_swift_tpu_torch.ops import nn as pnn

    tree = _tree_np(np.random.default_rng(0))
    packed = pq.quantize_tree(params_from_jax(tree, "cpu", torch.float32), 4)
    cast = pq.cast_tree(packed, torch.bfloat16)
    jcast = jq.cast_tree(jq.quantize_tree(tree, 4), jnp.bfloat16)
    assert cast["a"]["codes"].dtype == torch.int32 and cast["a"]["scales"].dtype == torch.float32
    assert cast["a"]["bias"].dtype == torch.bfloat16 and cast["norm"].dtype == torch.bfloat16
    assert str(jcast["a"]["bias"].dtype) == "bfloat16" and str(jcast["a"]["scales"].dtype) == "float32"
    np.testing.assert_array_equal(cast["a"]["bias"].float().numpy(),
                                  np.asarray(jcast["a"]["bias"], np.float32))
    for p, jp in ((packed["a"], jq.quantize_tree(tree, 4)["a"]), (
            {"kernel": torch.from_numpy(tree["a"]["kernel"]),
             "bias": torch.from_numpy(tree["a"]["bias"])}, tree["a"])):
        parts, jparts = pnn.split_linear(p, (64, 200)), jnn.split_linear(jp, (64, 200))
        assert len(parts) == len(jparts) == 3
        for part, jpart in zip(parts, jparts):
            assert set(part) == set(jpart)
            for k in part:
                got = part[k].numpy()
                np.testing.assert_array_equal(got.view(np.uint32) if k == "codes" else got,
                                              np.asarray(jpart[k]))
        fused = pnn.fuse_linears(parts)
        for k in p:
            assert torch.equal(fused[k], p[k]), k
