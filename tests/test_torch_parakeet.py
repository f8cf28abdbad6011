"""Parakeet TDT (``qwen3_asr_swift_tpu_torch/models/parakeet``) and the
depthwise 2-d conv (``ops/nn.py::depthwise_conv2d``) against their JAX
twins on the CPU.

One numpy-drawn tree at ``config_tiny()`` (every leaf jittered, so biases,
the u/v biases and the folded norms are not trivial) goes to both
packages. Modules within 1e-5 of max |reference| (fp32 both): the mel, the
relative shift and ``rel_attention``, the subsampling (the encoder at no
layers) and the whole encoder. The TDT decode's tokens and counts are
identical, for a batch of rows of different lengths with a row that
reaches ``max_tokens``, whatever the steps a host read. ``transcribe_batch``
at fp32 gives the reference's texts; in bf16 (the default) its tokens are
the reference's or part at a near-tie: each step's joint logits are read
in both packages, and at a row's first parting decision the reference's
margin between its choice and the port's is within twice the largest
logit difference there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.parakeet import encoder as j_enc
from qwen3_asr_swift_tpu.models.parakeet import mel as j_mel
from qwen3_asr_swift_tpu.models.parakeet import model as j_model
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.parakeet import encoder as p_enc
from qwen3_asr_swift_tpu_torch.models.parakeet import mel as p_mel
from qwen3_asr_swift_tpu_torch.models.parakeet import model as p_model
from qwen3_asr_swift_tpu_torch.models.parakeet.config import config_tiny
from qwen3_asr_swift_tpu_torch.ops import nn as p_nn

TOL = 1e-5
CFG = config_tiny()
J_CFG = j_model.config_tiny()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The decode is a chain of small ops: with several test workers on the
    host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jitter(tree, rng, scale=0.05):
    if isinstance(tree, dict):
        return {k: jitter(v, rng, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jitter(v, rng, scale) for v in tree]
    return (tree + scale * rng.standard_normal(np.shape(tree))).astype(np.float32)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err
    return err


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    enc = jitter(p_enc.init_encoder_params(np.random.default_rng(0), CFG), np.random.default_rng(1))
    dec = jitter(p_model.init_decoder_params(np.random.default_rng(2), CFG),
                 np.random.default_rng(3))
    return enc, dec


def noise(n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def test_configs_match():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(J_CFG)
    assert dataclasses.asdict(p_model.CONFIG_06B) == dataclasses.asdict(j_model.CONFIG_06B)
    assert p_model.PARAKEET_BUCKETS_S == j_model.PARAKEET_BUCKETS_S


@pytest.mark.parametrize("n", [7000, 16000 * 3 + 77])
def test_mel_matches(n):
    audio = noise(n, n)
    padded, nf = p_mel.prepare_nemo_audio(audio, CFG)
    total = p_mel.nemo_num_frames(CFG, 16000 * 4)
    need = (total - 1) * CFG.hop_length + CFG.n_fft
    buf = np.zeros(need, np.float32)
    buf[: len(padded)] = padded
    want, _ = j_mel.nemo_log_mel(jnp.asarray(buf), jnp.asarray(nf), J_CFG, total)
    got, _ = p_mel.nemo_log_mel(torch.from_numpy(buf)[None], torch.tensor([nf]), CFG, total)
    close(got[0], want)
    close(got[0, :nf], p_mel.nemo_log_mel_reference(audio, CFG), 1e-4)


@pytest.mark.parametrize("shape,k,stride,padding", [
    ((2, 17, 12, 8), 3, (2, 2), ((1, 1), (1, 1))),       # FastConformer's sub_dw
    ((1, 25, 19, 16), 7, (1, 1), ((0, 0), (3, 3))),      # the Zipformer's ConvNeXt
    ((1, 9, 10, 4), 3, (1, 2), ((2, 0), (1, 2)))])       # uneven strides and padding
def test_depthwise_conv2d_matches(shape, k, stride, padding):
    """The CPU twin of the card test: fp32 tap sums within 1e-5 of the
    reference's grouped ``conv_general_dilated``; bf16 (``F.conv2d``) within
    bf16 rounding."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    p = {"kernel": rng.standard_normal((k, k, 1, shape[-1])).astype(np.float32) / k,
         "bias": rng.standard_normal(shape[-1]).astype(np.float32) * 0.1}
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(p["kernel"]), stride, padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=shape[-1]) + p["bias"]
    got = p_nn.depthwise_conv2d(torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in p.items()},
                                stride=stride, padding=padding)
    close(got, want)
    got16 = p_nn.depthwise_conv2d(torch.from_numpy(x).bfloat16(),
                                  {n: torch.from_numpy(v) for n, v in p.items()},
                                  stride=stride, padding=padding)
    assert got16.dtype == torch.bfloat16
    close(got16.float(), want, 2 ** -6)


def test_rel_shift_and_rel_attention_match(trees):
    rng = np.random.default_rng(5)
    bd = rng.standard_normal((2, 2, 7, 13)).astype(np.float32)
    np.testing.assert_array_equal(p_enc._rel_shift(torch.from_numpy(bd)).numpy(),
                                  np.asarray(j_enc._rel_shift(jnp.asarray(bd))))
    enc = trees[0]
    lp = enc["layers"][0]["attn"]
    x = rng.standard_normal((2, 9, CFG.encoder_hidden)).astype(np.float32)
    valid = np.arange(9)[None] < np.array([[9], [6]])
    mask = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    u, v = enc["pos_u"], enc["pos_v"]
    want = j_enc.rel_attention(to_jax(lp), jnp.asarray(x), jnp.asarray(u), jnp.asarray(v),
                               jnp.asarray(mask), J_CFG)
    got = p_enc.rel_attention(params_from_jax(lp, "cpu", torch.float32), torch.from_numpy(x),
                              torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(mask), CFG)
    close(got, want)


def encode_pair(enc, mel, nf):
    want, wn = j_enc.encode(to_jax(enc), jnp.asarray(mel), jnp.asarray(nf), J_CFG)
    with torch.inference_mode():
        got, gn = p_enc.encode(params_from_jax(enc, "cpu", torch.float32), torch.from_numpy(mel),
                               torch.from_numpy(nf), CFG)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    return got, want


@pytest.mark.parametrize("layers", [0, 2], ids=["subsampling", "encoder"])
def test_encoder_matches(trees, layers):
    """The subsampling (the encoder at no layers: dw_striding through the
    depthwise conv, then the linear) and the whole encoder, on a batch of
    two rows of different valid lengths."""
    enc = dict(trees[0], layers=trees[0]["layers"][:layers])
    mel = np.random.default_rng(6).standard_normal((2, 93, CFG.num_mel_bins)).astype(np.float32)
    nf = np.array([93, 61], np.int32)
    mel[1, 61:] = 0.0
    got, want = encode_pair(enc, mel, nf)
    close(got, want)


def test_the_bucket_is_part_of_the_function(trees):
    """A clip near its bucket's edge: the encoder's last valid frames read
    the subsampling's frames past the clip, which are ReLU(bias) when the
    mel is padded to the bucket and zero when it is not, so the two part
    (the port pads as the reference does, ``ParakeetASR.prepare``); a clip
    whose valid frames do not reach past it agrees either way."""
    params = params_from_jax(trees[0], "cpu", torch.float32)
    parted = []
    for n in (16000 * 8 - 160 * 5, 16000 * 3 + 480):
        padded, nf = p_mel.prepare_nemo_audio(noise(n, 9), CFG)
        outs = []
        for total in (p_mel.nemo_num_frames(CFG, n), p_mel.nemo_num_frames(CFG, 16000 * 8)):
            need = (total - 1) * CFG.hop_length + CFG.n_fft
            buf = np.zeros((1, need), np.float32)
            buf[0, : min(need, len(padded))] = padded[:need]
            with torch.inference_mode():
                mel, _ = p_mel.nemo_log_mel(torch.from_numpy(buf), torch.tensor([nf]), CFG, total)
                x, no = p_enc.encode(params, mel, torch.tensor([nf]), CFG)
            outs.append(x[0, : int(no[0])])
        parted.append(((outs[0] - outs[1]).abs().max() / outs[1].abs().max()).item())
    print(f"bucket: near the edge {parted[0]:.3g}, clear of it {parted[1]:.3g}")
    assert parted[0] > 1e-3 and parted[1] <= TOL, parted
    asr = p_model.ParakeetASR(CFG, trees[0], trees[1], device="cpu")
    assert asr.prepare([noise(16000 * 3, 1)])[2] == p_mel.nemo_num_frames(CFG, 16000 * 8)


@pytest.mark.parametrize("check_steps", [1, 7, 32])
def test_tdt_decode_matches(trees, check_steps):
    """Rows of different lengths, one reaching ``max_tokens``: tokens,
    counts and log-probs equal whatever the steps between host reads."""
    dec = trees[1]
    rng = np.random.default_rng(8)
    encoded = rng.standard_normal((3, 23, CFG.encoder_hidden)).astype(np.float32)
    enc_len = np.array([23, 11, 4], np.int32)
    want = j_model.tdt_decode(to_jax(dec), J_CFG, jnp.asarray(encoded), jnp.asarray(enc_len), 6)
    loop = {}
    with torch.inference_mode():
        got = p_model.tdt_decode(params_from_jax(dec, "cpu", torch.float32), CFG,
                                 torch.from_numpy(encoded), torch.from_numpy(enc_len), 6,
                                 check_steps=check_steps, loop=loop)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[1], want[1])
    assert got[2].numpy().max() == 6 and len(set(got[2].tolist())) > 1, got[2]
    assert loop["reads"] == -(-loop["steps"] // check_steps) + 1


def clips():
    return [noise(n, i) for i, n in enumerate((16000 * 3, 16000 * 5 + 123, 7000))]


def test_transcribe_batch_matches_at_fp32(trees):
    ref = j_model.ParakeetASR(J_CFG, *trees, dtype=jnp.float32)
    port = p_model.ParakeetASR(CFG, *trees, dtype=torch.float32, device="cpu")
    want, got = ref.transcribe_batch(clips()), port.transcribe_batch(clips())
    assert [r.text for r in got] == [r.text for r in want]
    assert all(len(r.text.split()) > 3 for r in want)
    np.testing.assert_allclose([r.confidence for r in got], [r.confidence for r in want],
                               rtol=1e-5)
    assert port.last_loop["reads"] >= 2


def joint_steps(module, original, width):
    """Patch ``module.linear`` so each step's joint output ([B, width]) is
    recorded: (the recording list, the patch's undo)."""
    seen = []

    def record(x, p):
        y = original(x, p)
        if y.ndim == 2 and y.shape[-1] == width:
            if isinstance(y, torch.Tensor):
                seen.append(y.float().numpy())
            else:
                jax.debug.callback(lambda v: seen.append(np.asarray(v, np.float32)), y)
        return y
    return seen, record


def first_partings(ref_steps, port_steps, cfg, enc_len, max_tokens):
    """Per row, replay the reference's decisions step by step; return
    (row, step, reference logits, port logits, section) at each row's first
    step whose decision (token, or duration after a token) differs."""
    v = cfg.vocab_size + 1
    out = []
    for r in range(len(enc_len)):
        t = n = 0
        for s in range(min(len(ref_steps), len(port_steps))):
            if not (t < enc_len[r] and n < max_tokens):
                break
            lr, lp = ref_steps[s][r], port_steps[s][r]
            tok_r, tok_p = lr[:v].argmax(), lp[:v].argmax()
            if tok_r != tok_p:
                out.append((r, s, lr[:v], lp[:v]))
                break
            if tok_r == cfg.blank_token_id:
                t += 1
                continue
            dur_r, dur_p = lr[v:].argmax(), lp[v:].argmax()
            if dur_r != dur_p:
                out.append((r, s, lr[v:], lp[v:]))
                break
            t += max(cfg.duration_bins[dur_r], 1)
            n += tok_r >= cfg.first_text_token_id
    return out


def test_bf16_tokens_match_up_to_a_near_tie(trees):
    """bf16, the default dtype of both: the tokens are the reference's, or a
    row parts at a decision whose reference margin is within twice the
    largest joint-logit difference of that step (and that difference within
    2^-4 of max |ref|; every step before it within 5e-2 relative L2)."""
    width = CFG.vocab_size + 1 + CFG.num_duration_bins
    ref_steps, ref_linear = joint_steps(j_model, j_model.linear, width)
    port_steps, port_linear = joint_steps(p_model, p_model.linear, width)
    ref = j_model.ParakeetASR(J_CFG, *trees)
    port = p_model.ParakeetASR(CFG, *trees, device="cpu")
    assert port.dtype == torch.bfloat16
    orig = j_model.linear, p_model.linear
    j_model.linear, p_model.linear = ref_linear, port_linear
    try:
        want, got = ref.transcribe_batch(clips()), port.transcribe_batch(clips())
    finally:
        j_model.linear, p_model.linear = orig
    audios = clips()
    _, n_valid, _, _ = port.prepare(audios)
    from qwen3_asr_swift_tpu_torch.models.parakeet.encoder import subsampled_length

    enc_len = subsampled_length(n_valid).tolist()
    parts = first_partings(ref_steps, port_steps, CFG, enc_len, 64)
    same = [g.text == w.text for g, w in zip(got, want)]
    print(f"bf16: rows equal {same}; partings at (row, step) "
          f"{[(r, s) for r, s, *_ in parts]}")
    parted_rows = {r for r, *_ in parts}
    assert all(s or i in parted_rows for i, s in enumerate(same)), (same, parted_rows)
    for r, s, lr, lp in parts:
        gap = np.abs(lr - lp).max()
        margin = lr.max() - lr[lp.argmax()]
        print(f"  row {r} step {s}: margin {margin:.4g}, gap {gap:.4g}")
        assert gap <= 2 ** -4 * np.abs(lr).max() and margin <= 2 * gap, (r, s, margin, gap)
        for k in range(s):
            a, b = ref_steps[k][r], port_steps[k][r]
            assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(a), (r, k)
