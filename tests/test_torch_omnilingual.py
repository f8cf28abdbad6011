"""Omnilingual CTC (``qwen3_asr_swift_tpu_torch/models/omnilingual``)
against its JAX twin on the CPU.

One numpy-drawn tree at ``config_tiny()`` (every leaf jittered) goes to
both packages. ``omni_forward``'s log-probs over a clip padded to its
bucket within 1e-5 of max |reference| (fp32 both) and the CTC ids of
``transcribe`` identical, for clips in two buckets; the bucket is part of
the function (the positional conv carries the padded frames into the
valid ones). The reference cannot run its own default, bf16: its waveform
norm is fp32 and ``conv_general_dilated`` refuses an fp32 input with a
bf16 kernel (ROADMAP §3). The port casts the normed waveform to the
model's dtype; its bf16 ids are held against the reference's fp32 ones:
equal, or parting only at frames where the reference's margin between its
argmax and the port's is within twice the largest log-prob difference of
that frame (the difference itself within 2^-4 of max |ref|).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.omnilingual import model as j_model
from qwen3_asr_swift_tpu_torch.models.omnilingual import model as p_model

TOL = 1e-5
CFG = p_model.config_tiny()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
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


@pytest.fixture(scope="module")
def tree():
    return jitter(p_model.init_omni_params(np.random.default_rng(0), CFG), np.random.default_rng(1))


@pytest.fixture(scope="module")
def ref(tree):
    return j_model.OmnilingualASR(j_model.config_tiny(), tree, dtype=jnp.float32)


def noise(n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def test_configs_and_constants_match():
    for got, want in ((CFG, j_model.config_tiny()), (p_model.CONFIG_300M, j_model.CONFIG_300M),
                      (p_model.CONFIG_1B, j_model.CONFIG_1B)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert p_model.CONV_SPEC == j_model.CONV_SPEC and p_model.MAX_SECONDS == j_model.MAX_SECONDS
    assert p_model.OmnilingualASR.BUCKETS_S == j_model.OmnilingualASR.BUCKETS_S
    for n in (400, 16000, 80000, 123457):
        assert p_model.conv_output_length(n) == j_model.conv_output_length(n)


@pytest.mark.parametrize("n", [16000 * 3 + 77, 16000 * 7])
def test_forward_and_ids_match(tree, ref, n):
    audio = noise(n, n)
    port = p_model.OmnilingualASR(CFG, tree, dtype=torch.float32, device="cpu")
    bucket = next(s * 16000 for s in ref.BUCKETS_S if n <= s * 16000)
    padded = np.zeros(bucket, np.float32)
    padded[:n] = audio
    want, wf = ref._jit(ref.params, audio=jnp.asarray(padded),
                        n_valid_samples=jnp.asarray(n, jnp.int32))
    got, gf = port.log_probs(audio)
    assert gf == int(wf)
    close(got, want)
    assert port.transcribe(audio).text == ref.transcribe(audio).text
    assert len(ref.transcribe(audio).text.split()) > 10


def test_the_bucket_is_part_of_the_function(tree):
    """The positional conv's 16 taps (128 at the published widths) reach the
    padded frames, whose features are not zero: the same clip's valid
    log-probs part when it is padded to its bucket and when it is not."""
    audio = noise(16000 * 3, 4)
    port = p_model.OmnilingualASR(CFG, tree, dtype=torch.float32, device="cpu")
    bucketed, nf = port.log_probs(audio)
    with torch.inference_mode():
        bare, _ = p_model.omni_forward(port.params, CFG, torch.from_numpy(audio), len(audio))
    err = ((bare[:nf] - bucketed[:nf]).abs().max() / bucketed.abs().max()).item()
    assert err > 1e-3, err


def test_ctc_greedy_collapse_matches():
    rng = np.random.default_rng(3)
    for _ in range(5):
        t = rng.integers(0, 4, 40)
        assert p_model.ctc_greedy_collapse(t, 0) == j_model.ctc_greedy_collapse(t, 0)


def test_reference_cannot_run_bf16(tree):
    """The reference's default dtype: its fp32 waveform meets a bf16 kernel."""
    with pytest.raises(TypeError, match="same dtypes"):
        j_model.OmnilingualASR(j_model.config_tiny(), tree).transcribe(noise(16000, 5))


def test_bf16_ids_match_up_to_a_near_tie(tree, ref):
    audio = noise(16000 * 3 + 77, 6)
    port = p_model.OmnilingualASR(CFG, tree, device="cpu")
    assert port.dtype == torch.bfloat16
    got, nf = port.log_probs(audio)
    got = got[:nf].numpy()
    padded = np.zeros(5 * 16000, np.float32)
    padded[: len(audio)] = audio
    want, _ = ref._jit(ref.params, audio=jnp.asarray(padded),
                       n_valid_samples=jnp.asarray(len(audio), jnp.int32))
    want = np.asarray(want)[:nf]
    parted = np.nonzero(got.argmax(-1) != want.argmax(-1))[0]
    gaps = np.abs(got - want).max(-1)
    print(f"bf16: {len(parted)} of {nf} frames part; largest gap {gaps.max():.4g} "
          f"({gaps.max() / np.abs(want).max():.3g} of max |ref|)")
    assert gaps.max() <= 2 ** -4 * np.abs(want).max()
    for f in parted:
        margin = want[f].max() - want[f, got[f].argmax()]
        assert margin <= 2 * gaps[f], (f, margin, gaps[f])
    assert len(parted) < nf // 4
