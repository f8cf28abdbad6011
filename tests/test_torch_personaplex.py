"""The port's PersonaPlex and Mimi against the JAX package's, on the CPU.

Both packages take the same numpy weights (drawn by the port's
initialisers), in fp32:

- Mimi: encode codes identical, the encoder latent and the decoded
  waveform within 1e-5 of max |ref|;
- ``temporal_prefill``/``temporal_step`` hidden states (fused and
  unfused) and the depformer's teacher-forced logits within 1e-5;
- ``user_stream_reads``, ``depformer_provided_tokens`` and the prompt's
  read table (with and without a voice ring) identical;
- greedy ``respond``: every agent code and ``last_text_tokens`` identical
  to the reference's, dense at ``config_tiny()`` and packed 4-bit at a
  tiny config of widths ≥ 128 (``quantize_tree`` packs; on the CPU the
  packed products take K1's plain version, as the reference takes its XLA
  path); the waveform within 1e-5;
- the silence stop (weights made to emit the silence codes): the same
  codes and ``n_steps`` as the reference, whatever the stop-read cadence;
- ``respond_stream`` pieces summing to ``respond``;
- voice prompts from codes and from a file, equal to the reference's;
- ``_sample_topk`` equal to the reference's at temperature 0, and its
  temperature held by the distribution of many draws;
- ``from_pretrained`` on a checkpoint the test writes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_asr_swift_tpu.models.personaplex import PersonaPlex as JaxPlex
from qwen3_asr_swift_tpu.models.personaplex import PersonaSampling as JaxSampling
from qwen3_asr_swift_tpu.models.personaplex import mimi as jmimi
from qwen3_asr_swift_tpu.models.personaplex import model as jmodel
from qwen3_asr_swift_tpu.ops.kv_cache import init_cache as jax_init_cache
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.personaplex import PersonaPlex, PersonaSampling
from qwen3_asr_swift_tpu_torch.models.personaplex import convert as pconvert
from qwen3_asr_swift_tpu_torch.models.personaplex import mimi as pmimi
from qwen3_asr_swift_tpu_torch.models.personaplex import model as pmodel
from qwen3_asr_swift_tpu_torch.ops.kv_cache import init_cache

TOL = 1e-5
CFG, JCFG = pmodel.config_tiny(), jmodel.config_tiny()
SPF = CFG.mimi.samples_per_frame
SR = CFG.mimi.sample_rate
GREEDY = dict(audio_temperature=0.0, text_temperature=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def weights(cfg=CFG, seed=0):
    rng = np.random.default_rng(seed)
    return pmodel.init_personaplex_params(rng, cfg), pmimi.init_mimi_params(rng, cfg.mimi)


def pair(cfg=CFG, jcfg=JCFG, seed=0, params=None, quant_bits=None):
    """(port model, reference model) on the same numpy weights, fp32."""
    p, m = weights(cfg, seed)
    p = params if params is not None else p
    port = PersonaPlex(cfg, p, m, device="cpu", dtype=torch.float32, quant_bits=quant_bits)
    if quant_bits:
        from qwen3_asr_swift_tpu_torch.core.params import quantize_tree_np

        p = quantize_tree_np(p, quant_bits, embed_keys=())
    return port, JaxPlex(jcfg, p, m, dtype=jnp.float32)


@pytest.fixture(scope="module")
def models():
    return pair()


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def clip(frames, seed=1):
    return (0.2 * np.random.default_rng(seed).standard_normal(frames * SPF)).astype(np.float32)


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_mimi_matches():
    _, m = weights()
    jp, pp = jtree(m), params_from_jax(m, "cpu", torch.float32)
    audio = clip(6)[None]
    want = np.asarray(jmimi.mimi_encode(jp, jmimi.config_tiny(), jnp.asarray(audio)))
    got = pmimi.mimi_encode(pp, CFG.mimi, torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(got, want)
    lat_j = jmimi.mimi_encode_latent(jp, jmimi.config_tiny(), jnp.asarray(audio))
    lat_p = pmimi.mimi_encode_latent(pp, CFG.mimi, torch.from_numpy(audio))
    assert rel(lat_p.numpy(), lat_j) < TOL
    codes = np.random.default_rng(2).integers(0, CFG.mimi.codebook_size, (2, 16, 5))
    want = np.asarray(jmimi.mimi_decode(jp, jmimi.config_tiny(), jnp.asarray(codes)))
    got = pmimi.mimi_decode(pp, CFG.mimi, torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (2, 5 * SPF)
    assert rel(got, want) < TOL, rel(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_temporal_prefill_and_step_match(fused):
    params, _ = weights()
    jp = jtree(jmodel.fuse_temporal_params(jtree(params)) if fused else params)
    pp = params_from_jax(params, "cpu", torch.float32)
    if fused:
        pp = pmodel.fuse_temporal_params(pp)
        assert "qkv_proj" in pp["layers"][0]
        back = pmodel.unfuse_temporal_params(pp, CFG)
        for name in ("q_proj", "k_proj", "v_proj"):
            np.testing.assert_array_equal(back["layers"][1][name]["kernel"].numpy(),
                                          params["layers"][1][name]["kernel"])
    rng = np.random.default_rng(3)
    t, n_max = 7, 12
    embeds = rng.standard_normal((1, t, CFG.d_model)).astype(np.float32)
    valid = np.array([[False, True, True, False, True, True, True]])
    jc = jax_init_cache(CFG.num_layers, 1, CFG.num_heads, n_max, CFG.head_dim, jnp.float32)
    jh, jc = jmodel.temporal_prefill(jp, JCFG, jnp.asarray(embeds), jnp.asarray(valid), jc)
    pc = init_cache(CFG.num_layers, 1, CFG.num_heads, n_max, CFG.head_dim, torch.float32,
                    device="cpu")
    ph, pc = pmodel.temporal_prefill(pp, CFG, torch.from_numpy(embeds), torch.from_numpy(valid),
                                     pc)
    rows = valid[0]
    assert rel(ph.numpy()[0, rows], np.asarray(jh)[0, rows]) < TOL
    for _ in range(3):
        x = rng.standard_normal((1, 1, CFG.d_model)).astype(np.float32)
        jh, jc = jmodel.temporal_step(jp, JCFG, jnp.asarray(x), jc)
        ph, pc = pmodel.temporal_step(pp, CFG, torch.from_numpy(x), pc)
        assert rel(ph.numpy(), jh) < TOL, rel(ph.numpy(), jh)


def test_depformer_logits_and_generate_match():
    params, _ = weights()
    jp, pp = jtree(params), params_from_jax(params, "cpu", torch.float32)
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((2, CFG.d_model)).astype(np.float32)
    text = np.array([3, 17])
    audio = rng.integers(0, CFG.audio_card, (2, 16))
    want = jmodel.depformer_forward_logits(jp, JCFG, jnp.asarray(hidden), jnp.asarray(text),
                                           jnp.asarray(audio))
    got = pmodel.depformer_forward_logits(pp, CFG, torch.from_numpy(hidden),
                                          torch.from_numpy(text), torch.from_numpy(audio))
    assert got.shape == want.shape == (2, 16, CFG.audio_card)
    assert rel(got.numpy(), want) < TOL
    provided = np.full((2, 16), -1)
    provided[:, 8:] = np.arange(8) + 10
    hist = rng.integers(0, CFG.audio_card, (2, 16, 5))
    hist[:, :, 0] = CFG.audio_pad                   # an empty slot: out of range
    for kw in (dict(), dict(provided=provided), dict(history=hist)):
        js = JaxSampling(**GREEDY)
        want = jmodel.depformer_generate(jp, JCFG, jnp.asarray(hidden), jnp.asarray(text),
                                         jax.random.PRNGKey(0), js,
                                         **{k: jnp.asarray(v) for k, v in kw.items()})
        got = pmodel.depformer_generate(pp, CFG, torch.from_numpy(hidden),
                                        torch.from_numpy(text), None, PersonaSampling(**GREEDY),
                                        **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_schedules_identical():
    k, user_frames = CFG.temporal_codebooks, 5
    codes = (100 * np.arange(16)[None, :, None] + np.arange(user_frames)[None, None, :])
    pred = np.full((1, k), 7000)
    for step in range(user_frames + 3):
        want = jmodel.user_stream_reads(jnp.asarray(codes), jnp.asarray(pred),
                                        jnp.asarray(step, jnp.int32), user_frames, k)
        got = pmodel.user_stream_reads(torch.from_numpy(codes), torch.from_numpy(pred), step,
                                       user_frames, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = jmodel.depformer_provided_tokens(jnp.asarray(codes), jnp.asarray(step, jnp.int32),
                                                user_frames, JCFG)
        got = pmodel.depformer_provided_tokens(torch.from_numpy(codes), step, user_frames, CFG)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prompt_reads_identical(models):
    port, ref = models
    ring = (np.arange(17 * 4, dtype=np.int32).reshape(17, 4) * 7) % 1000
    for prompt, n_voice, rg in (([5, 7, 9], 0, None), ([], 4, ring), ([1, 2], 5, ring),
                                (None, 0, None)):
        got, n_got = port._prompt_reads(prompt, n_voice, rg)
        want, n_want = ref._prompt_reads(prompt, n_voice, rg)
        np.testing.assert_array_equal(got, want)
        assert n_got == n_want
    with pytest.raises(ValueError):
        port._prompt_tokens("a string prompt needs the tokenizer")


# ---------------------------------------------------------------------------
# the conversation
# ---------------------------------------------------------------------------

def respond_both(port, ref, audio, samp, **kw):
    got, gdiag = port.respond_diagnostic(audio, SR, sampling=PersonaSampling(**samp), **kw)
    want, wdiag = ref.respond_diagnostic(audio, SR, sampling=JaxSampling(**samp), **kw)
    return got, gdiag, want, wdiag


def packed_cfgs():
    wide = dict(d_model=128, num_heads=4, head_dim=32, intermediate_size=128, text_vocab=128)
    return dataclasses.replace(CFG, **wide), dataclasses.replace(JCFG, **wide)


@pytest.mark.parametrize("packed", [False, True])
def test_greedy_respond_identical(models, packed):
    if packed:
        cfg, jcfg = packed_cfgs()
        port, ref = pair(cfg, jcfg, seed=5, quant_bits=4)
        assert "codes" in port.params["layers"][0]["qkv_proj"]
        assert "codes" in port.params["text_head"]
    else:
        port, ref = models
    samp = dict(GREEDY, max_steps=9)
    got, gdiag, want, wdiag = respond_both(port, ref, clip(4), samp, max_extra_s=1.0,
                                           system_prompt=[5, 9, 2])
    np.testing.assert_array_equal(gdiag["agent_tokens"], wdiag["agent_tokens"])
    np.testing.assert_array_equal(gdiag["text_tokens"], wdiag["text_tokens"])
    np.testing.assert_array_equal(gdiag["text_top_token"], wdiag["text_top_token"])
    for name in ("text_top_logit", "text_entropy", "hidden_stats"):
        assert rel(gdiag[name], wdiag[name]) < TOL, name
    assert len(got.samples) == len(want.samples) == 9 * SPF
    assert rel(got.samples, want.samples) < TOL
    plain = port.respond(clip(4), SR, sampling=PersonaSampling(**samp), max_extra_s=1.0,
                         system_prompt=[5, 9, 2])
    np.testing.assert_array_equal(plain.samples, got.samples)
    np.testing.assert_array_equal(port.last_text_tokens, ref.last_text_tokens)
    assert port.last_transcript is None
    assert port.last_loop == {"frames_run": 9, "stop_reads": 1}


def silent_params(cfg=CFG, seed=0):
    """Weights whose depformer emits the silence codes on the agent
    codebooks: a large constant on hidden dimension 0 (every depformer
    input embedding carries it, no norm precedes the heads) and a large
    head weight from it to each codebook's silence code."""
    params, _ = weights(cfg, seed)
    params["dep_text_emb"][:, 0] = 100.0
    params["dep_embed"][:, :, 0] = 100.0
    for i, code in enumerate(pmodel.SILENCE_TOKENS):
        params["dep_heads_bank"][i, 0, code] = 10.0
    return params


def test_silence_stop_identical():
    port, ref = pair(params=silent_params())
    frames = 3
    samp = dict(GREEDY, max_steps=40, silence_stop_frames=15)
    got, gdiag, want, wdiag = respond_both(port, ref, clip(frames), samp, max_extra_s=4.0)
    n = frames + 15
    assert gdiag["agent_tokens"].shape == wdiag["agent_tokens"].shape == (16, n)
    np.testing.assert_array_equal(gdiag["agent_tokens"], wdiag["agent_tokens"])
    # the codes come back clipped to the tiny Mimi's 64 entries
    silence = np.minimum(pmodel.SILENCE_TOKENS, CFG.mimi.codebook_size - 1)
    np.testing.assert_array_equal(gdiag["agent_tokens"][:8, frames:],
                                  silence[:, None].repeat(15, 1))
    np.testing.assert_array_equal(gdiag["text_tokens"], wdiag["text_tokens"])
    assert len(got.samples) == len(want.samples) == n * SPF
    assert rel(got.samples, want.samples) < TOL
    # the loop ran on to its next read of the stop flag, and recorded nothing
    run = port.last_loop["frames_run"]
    assert run == -(-n // pmodel.STOP_CHECK_FRAMES) * pmodel.STOP_CHECK_FRAMES
    old = pmodel.STOP_CHECK_FRAMES
    try:
        pmodel.STOP_CHECK_FRAMES = 1
        _, again = port.respond_diagnostic(clip(frames), SR, sampling=PersonaSampling(**samp),
                                           max_extra_s=4.0)
        assert port.last_loop["frames_run"] == n
    finally:
        pmodel.STOP_CHECK_FRAMES = old
    np.testing.assert_array_equal(again["agent_tokens"], gdiag["agent_tokens"])


def test_respond_stream_sums_to_respond(models):
    port, _ = models
    samp = PersonaSampling(**GREEDY, max_steps=7)
    whole = port.respond(clip(3, seed=6), SR, sampling=samp, max_extra_s=1.0).samples
    pieces = list(port.respond_stream(clip(3, seed=6), SR, sampling=samp, max_extra_s=1.0,
                                      chunk_frames=2, left_context=1))
    assert len(pieces) == 4 and sum(len(p.samples) for p in pieces) == len(whole)
    full = list(port.respond_stream(clip(3, seed=6), SR, sampling=samp, max_extra_s=1.0,
                                    chunk_frames=3, left_context=100))
    got = np.concatenate([p.samples for p in full])
    assert rel(got, whole) < TOL


def test_voice_prompts_match(models, tmp_path):
    port, ref = models
    codes = np.random.default_rng(7).integers(0, 2048, (1, 16, 5)).astype(np.int32)
    pe, pn, pr = port._voice_inputs({"codes": codes})
    je, jn, jr = ref._voice_inputs({"codes": codes})
    assert pn == jn == 5
    np.testing.assert_array_equal(pr, jr)
    assert rel(pe.numpy(), je) < TOL
    voice = np.sin(np.linspace(0, 60, 4 * SPF)).astype(np.float32) * 0.3
    path = str(tmp_path / "voice.safetensors")
    got = port.make_voice_prompt(voice, SR, path=path)
    want = ref.make_voice_prompt(voice, SR)
    np.testing.assert_array_equal(got["cache"], want["cache"])
    assert rel(got["embeddings"], want["embeddings"]) < TOL
    loaded = port.load_voice_prompt(path)
    np.testing.assert_array_equal(loaded["embeddings"], got["embeddings"])
    samp = dict(GREEDY, max_steps=6)
    _, gdiag, _, wdiag = respond_both(port, ref, clip(2, seed=8), samp, max_extra_s=1.0,
                                      voice_prompt=path)
    np.testing.assert_array_equal(gdiag["agent_tokens"], wdiag["agent_tokens"])
    np.testing.assert_array_equal(gdiag["text_tokens"], wdiag["text_tokens"])
    # a named preset resolves from the snapshot's voices/ directory
    (tmp_path / "voices").mkdir()
    port.make_voice_prompt(voice, SR, path=str(tmp_path / "voices" / "NATF1.safetensors"))
    port.model_dir = str(tmp_path)
    try:
        assert port.available_voices == ["NATF1"]
        e1, n1, r1 = port._voice_inputs("NATF1")
        np.testing.assert_array_equal(r1, port._voice_inputs(path)[2])
        with pytest.raises(FileNotFoundError):
            port.voice("VARM4")
    finally:
        port.model_dir = None
    with pytest.raises(ValueError):
        port.voice("NATF1")


def test_sample_topk_matches_reference():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((64, 40)).astype(np.float32)
    hist = rng.integers(-2, 45, (64, 6))        # negative and out-of-range slots are inert
    for top_k, penalty in ((0, 1.0), (5, 1.0), (0, 1.7), (7, 3.0), (60, 1.2)):
        want = jmodel._sample_topk(jnp.asarray(logits), jax.random.PRNGKey(0), top_k, 0.0,
                                   history=jnp.asarray(hist), penalty=penalty)
        got = pmodel._sample_topk(torch.from_numpy(logits), None, top_k, 0.0,
                                  history=torch.from_numpy(hist), penalty=penalty)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lg = torch.tensor([[0.5, 1.0]])
    assert int(pmodel._sample_topk(lg, None, 0, 0.0, history=torch.tensor([[1]]),
                                   penalty=4.0)[0]) == 0
    assert int(pmodel._sample_topk(torch.tensor([[-0.5, -0.1]]), None, 0, 0.0,
                                   history=torch.tensor([[1]]), penalty=10.0)[0]) == 0
    with pytest.raises(ValueError):
        pmodel._sample_topk(lg, None, 0, 0.7)


def test_temperature_draws_follow_the_softmax():
    logits = torch.tensor([2.0, 1.0, 0.5, -1.0, 0.0])
    n, temp, top_k = 40000, 0.8, 3
    gen = torch.Generator().manual_seed(0)
    draws = pmodel._sample_topk(logits.expand(n, -1), gen, top_k, temp)
    freq = torch.bincount(draws, minlength=5).double() / n
    kept = torch.tensor([0, 1, 2])
    p = torch.zeros(5, dtype=torch.float64)
    p[kept] = torch.softmax(logits[kept].double() / temp, dim=0)
    assert torch.all((freq - p).abs() < 0.01), (freq, p)
    again = pmodel._sample_topk(logits.expand(n, -1), torch.Generator().manual_seed(0), top_k, temp)
    assert torch.equal(draws, again)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def mimi_state_dict(m, cfg):
    """The HF MimiModel naming of a canonical Mimi tree (the inverse of
    ``convert_mimi_tree``)."""
    sd = {}

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(p["w"].transpose(2, 1, 0))
        if "b" in p:
            sd[f"{prefix}.bias"] = p["b"]

    def conv_t(prefix, p):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(p["w"][::-1].transpose(1, 2, 0))
        if "b" in p:
            sd[f"{prefix}.bias"] = p["b"]

    enc, dec = m["encoder"], m["decoder"]
    conv("encoder.layers.0.conv", enc["conv_in"])
    idx = 1
    for st in enc["stages"]:
        conv(f"encoder.layers.{idx}.block.1.conv", st["res"]["conv1"])
        conv(f"encoder.layers.{idx}.block.3.conv", st["res"]["conv2"])
        conv(f"encoder.layers.{idx + 2}.conv", st["down"])
        idx += 3
    conv(f"encoder.layers.{idx + 1}.conv", enc["conv_out"])
    conv("decoder.layers.0.conv", dec["conv_in"])
    idx = 2
    for st in dec["stages"]:
        conv_t(f"decoder.layers.{idx}.conv", st["up"])
        conv(f"decoder.layers.{idx + 1}.block.1.conv", st["res"]["conv1"])
        conv(f"decoder.layers.{idx + 1}.block.3.conv", st["res"]["conv2"])
        idx += 3
    conv(f"decoder.layers.{idx}.conv", dec["conv_out"])
    for side in ("encoder_transformer", "decoder_transformer"):
        for i, lp in enumerate(m[side]):
            pre = f"{side}.layers.{i}"
            sd[f"{pre}.input_layernorm.weight"] = lp["ln1"]["weight"]
            sd[f"{pre}.input_layernorm.bias"] = lp["ln1"]["bias"]
            sd[f"{pre}.post_attention_layernorm.weight"] = lp["ln2"]["weight"]
            sd[f"{pre}.post_attention_layernorm.bias"] = lp["ln2"]["bias"]
            for name, key in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "o_proj")):
                sd[f"{pre}.self_attn.{key}.weight"] = np.ascontiguousarray(lp[name]["kernel"].T)
            sd[f"{pre}.mlp.fc1.weight"] = np.ascontiguousarray(lp["fc1"]["kernel"].T)
            sd[f"{pre}.mlp.fc2.weight"] = np.ascontiguousarray(lp["fc2"]["kernel"].T)
            sd[f"{pre}.self_attn_layer_scale.scale"] = lp["attn_scale"]
            sd[f"{pre}.mlp_layer_scale.scale"] = lp["mlp_scale"]
    sd["downsample.conv.weight"] = np.ascontiguousarray(m["downsample"]["w"].transpose(2, 1, 0))
    sd["upsample.conv.weight"] = np.ascontiguousarray(m["upsample"]["w"][::-1].transpose(2, 1, 0))
    for name, full in (("semantic", "semantic_residual_vector_quantizer"),
                       ("acoustic", "acoustic_residual_vector_quantizer")):
        q = m["quantizer"][name]
        pre = f"quantizer.{full}"
        sd[f"{pre}.input_proj.weight"] = np.ascontiguousarray(q["input_proj"]["w"].transpose(2, 1, 0))
        sd[f"{pre}.output_proj.weight"] = np.ascontiguousarray(q["output_proj"]["w"].transpose(2, 1, 0))
        for i in range(q["embed_sum"].shape[0]):
            sd[f"{pre}.layers.{i}.codebook.embed_sum"] = q["embed_sum"][i]
            sd[f"{pre}.layers.{i}.codebook.cluster_usage"] = q["cluster_usage"][i]
    return sd


def test_from_pretrained_reads_a_written_checkpoint(models, tmp_path):
    from safetensors.numpy import save_file

    port, _ = models
    params, mimi = weights()
    sd = pconvert.export_moshi_state_dict(params, CFG)
    files = {"temporal.safetensors": lambda k: k.startswith("layers.") or k == "out_norm.alpha",
             "depformer.safetensors": lambda k: k.startswith(("depformer", "linears."))}
    groups = {name: {} for name in files}
    groups["embeddings.safetensors"] = {}
    for key, val in sd.items():
        name = next((n for n, pick in files.items() if pick(key)), "embeddings.safetensors")
        groups[name][key] = np.ascontiguousarray(val, np.float32)
    for name, tensors in groups.items():
        save_file(tensors, str(tmp_path / name))
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in mimi_state_dict(mimi, CFG.mimi).items()},
              str(tmp_path / "mimi.safetensors"))
    loaded = PersonaPlex.from_pretrained(str(tmp_path), cfg=CFG, device="cpu",
                                         dtype=torch.float32)
    assert loaded.model_dir == str(tmp_path) and loaded.tokenizer is None
    samp = PersonaSampling(**GREEDY, max_steps=5)
    want = port.respond(clip(2, seed=10), SR, sampling=samp, max_extra_s=1.0)
    got = loaded.respond(clip(2, seed=10), SR, sampling=samp, max_extra_s=1.0)
    np.testing.assert_array_equal(loaded.last_text_tokens, port.last_text_tokens)
    assert rel(got.samples, want.samples) < TOL
    (tmp_path / "mimi.safetensors").unlink()
    with pytest.raises(FileNotFoundError):
        PersonaPlex.from_pretrained(str(tmp_path), cfg=CFG, device="cpu")
    with pytest.raises(FileNotFoundError):
        PersonaPlex.from_pretrained("nvidia/personaplex-7b-v1", device="cpu",
                                    cache_dir=str(tmp_path / "cache"), offline_mode=True)
