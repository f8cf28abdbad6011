"""The port's device frontend: wire decoders and log-mel, against the JAX
package's device functions and its numpy references.

Tolerances: wire decoders 1e-6 absolute (the same fp32 elementwise math;
dpcm4's cumsum may add in another order); log-mel 1e-4 absolute against
the JAX kernel (two fp32 DFT matmuls summed over 400 taps, then log10)
and 2e-3 against ``log_mel_reference`` (float64 per-frame FFT), the bound
the JAX package's own mel tests hold its kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.audio import companding as jc
from qwen3_asr_swift_tpu.ops import mel as jmel
from qwen3_asr_swift_tpu_torch.audio import companding as pc
from qwen3_asr_swift_tpu_torch.ops.mel import log_mel_kernel


def speechish(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


def test_mulaw_decode():
    y = jc.mulaw_encode_np(speechish(4000, 0))
    got = pc.mulaw_decode(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, jc.mulaw_decode_np(y), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jc.mulaw_decode(jnp.asarray(y))), atol=1e-6)


def test_pcm4_decode():
    packed, scales = jc.pcm4_encode_np(speechish(2 * 2048, 1).reshape(2, 2048))
    got = pc.pcm4_decode(torch.from_numpy(packed), torch.from_numpy(scales)).numpy()
    np.testing.assert_allclose(got, jc.pcm4_decode_np(packed, scales), atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jc.pcm4_decode(jnp.asarray(packed), jnp.asarray(scales))), atol=1e-6)


def test_dpcm4_decode():
    packed, scales2 = jc.dpcm4_encode_np(speechish(2 * 2048, 2).reshape(2, 2048))
    got = pc.dpcm4_decode(torch.from_numpy(packed), torch.from_numpy(scales2)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, jc.dpcm4_decode_np(packed, scales2), atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jc.dpcm4_decode(jnp.asarray(packed), jnp.asarray(scales2))), atol=1e-6)


@pytest.mark.parametrize("seconds,bucket_s", [(1.3, 2), (0.4, 1)])
def test_log_mel_kernel_matches_jax_and_reference(seconds, bucket_s):
    cfg = jmel.MelConfig()
    clips = [speechish(int(seconds * 16000), 3), speechish(int(seconds * 8000), 4)]
    total = bucket_s * 100
    need = (total - 1) * cfg.hop_length + cfg.n_fft
    batch = np.zeros((2, need), np.float32)
    n_valid = []
    for i, a in enumerate(clips):
        padded = jmel.reflect_pad_np(a, cfg.n_fft // 2)[:need]
        batch[i, : len(padded)] = padded
        n_valid.append(jmel.num_frames(cfg, len(a)))
    got = log_mel_kernel(torch.from_numpy(batch), torch.tensor(n_valid), cfg, total).numpy()
    assert got.shape == (2, cfg.n_mels, total)
    for i, a in enumerate(clips):
        ref = np.asarray(jmel.log_mel_kernel(jnp.asarray(batch[i]), n_valid[i], cfg, total))
        np.testing.assert_allclose(got[i], ref, atol=1e-4)
        gold = jmel.log_mel_reference(a, cfg)
        np.testing.assert_allclose(got[i, :, : n_valid[i]], gold, atol=2e-3)
        assert np.all(got[i, :, n_valid[i]:] == 0)
