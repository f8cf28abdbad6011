"""The port's Silero VAD against the JAX package's, on the same weights
(drawn with numpy from a seed and handed to both).

- speech probabilities within 1e-5 of the reference's (fp32 in both; the
  port batches the stateless front half over all chunks and loops only the
  LSTM, the reference scans whole steps);
- chunk-by-chunk ``process_chunk`` within 1e-6 of the batch pass;
- ``binarize`` and ``StreamingVADProcessor`` events equal to the
  reference's (host code, copies), with thresholds clear of every
  probability by more than ten times the probabilities' tolerance, so
  that no event can flip between the packages;
- ``from_pretrained`` on archives the test writes: an MLX-converted
  safetensors directory and an upstream-layout TorchScript ``.jit``.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.silero_vad import model as j_model
from qwen3_asr_swift_tpu.models.silero_vad import streaming as j_stream
from qwen3_asr_swift_tpu_torch.models.silero_vad import model as p_model
from qwen3_asr_swift_tpu_torch.models.silero_vad import streaming as p_stream
from qwen3_asr_swift_tpu_torch.ops.nn import conv1d

SR = 16000


def bursts(seconds: float, seed: int) -> np.ndarray:
    """Noise bursts of 1-3 s between stretches of silence, from a seed."""
    rng = np.random.default_rng(seed)
    out, loud, total = [], True, 0
    while total < int(seconds * SR):
        n = int(rng.uniform(1.0, 3.0) * SR)
        out.append((0.3 if loud else 0.0) * rng.standard_normal(n).astype(np.float32))
        total += n
        loud = not loud
    return np.concatenate(out)[: int(seconds * SR)].astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The VAD's chunk loops are chains of tiny ops: with several test
    workers on the host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def params():
    return p_model.init_params(0)


@pytest.fixture(scope="module")
def vads(params):
    return p_model.SileroVAD(params, device="cpu"), j_model.SileroVAD(params)


@pytest.fixture(scope="module")
def audio():
    return bursts(12.0, seed=1)


@pytest.fixture(scope="module")
def probs(vads, audio):
    """Both packages' batch probabilities of ``audio``."""
    pv, jv = vads
    return pv.speech_probabilities(audio), jv.speech_probabilities(audio)


def test_init_params_have_the_reference_topology(params):
    import jax

    want = jax.tree_util.tree_map(lambda a: np.asarray(a).shape, j_model.init_params())
    got = jax.tree_util.tree_map(lambda a: np.asarray(a).shape, params)
    assert got == want
    np.testing.assert_array_equal(params["stft_basis"], j_model.dft_basis())


def test_probabilities_match_reference(probs):
    got, want = probs
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resampled_probabilities_match_reference(vads, audio):
    pv, jv = vads
    x = audio[: 4 * SR : 2].copy()
    np.testing.assert_allclose(pv.speech_probabilities(x, 8000), jv.speech_probabilities(x, 8000),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [1, 100, 512, 513, 5000])
def test_short_and_ragged_inputs(vads, n):
    pv, jv = vads
    x = (0.2 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    np.testing.assert_allclose(pv.speech_probabilities(x), jv.speech_probabilities(x),
                               atol=1e-5, rtol=0)


def test_streaming_equals_batch(vads, audio, probs):
    pv, jv = vads
    batch = probs[0]
    state, probs = pv.new_stream(), []
    for i in range(len(batch)):
        state, p = pv.process_chunk(state, audio[i * 512:(i + 1) * 512])
        probs.append(p)
    np.testing.assert_allclose(np.array(probs), batch, atol=1e-6, rtol=0)
    jstate = jv.new_stream()
    jstate, jp = jv.process_chunk(jstate, audio[:512])
    assert abs(jp - probs[0]) <= 1e-5


def test_forward_chunk_matches_reference_at_batch_4(params):
    rng = np.random.default_rng(5)
    samples = (0.2 * rng.standard_normal((4, 576))).astype(np.float32)
    h = (0.1 * rng.standard_normal((4, 128))).astype(np.float32)
    c = (0.1 * rng.standard_normal((4, 128))).astype(np.float32)
    tp = p_model._to_device(params, "cpu")
    got = p_model.forward_chunk(tp, *(torch.from_numpy(a) for a in (samples, h, c)))
    want = j_model.forward_chunk(params, samples, h, c)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def _conv1d_pair(stride, padding, groups=1, dilation=1, out=5):
    from qwen3_asr_swift_tpu.ops import nn as jnn

    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    p = {"kernel": rng.standard_normal((3, 6 // groups, out)).astype(np.float32),
         "bias": rng.standard_normal(out).astype(np.float32)}
    want = np.asarray(jnn.conv1d(x, p, stride=stride, padding=padding, groups=groups,
                                 dilation=dilation))
    got = conv1d(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                 stride=stride, padding=padding, groups=groups, dilation=dilation).numpy()
    assert got.shape == want.shape
    return got, want


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (2, ((0, 2),)), (1, 0)])
def test_conv1d_matches_reference(stride, padding):
    got, want = _conv1d_pair(stride, padding)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("stride,padding,groups,dilation",
                         [(1, 2, 2, 1), (2, 3, 1, 2), (1, ((1, 3),), 3, 2)])
def test_conv1d_groups_and_dilation_match_reference(stride, padding, groups, dilation):
    got, want = _conv1d_pair(stride, padding, groups, dilation, out=6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


#: how far every probability must lie from a threshold: ten times the 1e-5
#: to which the two packages' probabilities are held, so that no event can
#: flip between them (a random Silero's probabilities stay within ±0.03 of
#: 0.5 and a silence decays to 0.5 smoothly, so there are no gaps of 2e-3)
MARGIN = 1e-4


def clear_thresholds(probs, margin=MARGIN):
    """(onset, offset): the middles of the two widest gaps between sorted
    probabilities, the top and bottom 5 % left out; each must clear every
    probability by more than ``margin``."""
    s = np.sort(probs)
    gaps = np.diff(s)
    lo, hi = len(s) // 20, len(s) - len(s) // 20
    k1, k2 = sorted(lo + np.argsort(gaps[lo:hi])[-2:])
    offset, onset = (s[k1] + s[k1 + 1]) / 2, (s[k2] + s[k2 + 1]) / 2
    assert np.abs(probs - onset).min() > margin and np.abs(probs - offset).min() > margin
    return float(onset), float(offset)


def segments(segs):
    return [(s.start, s.end, s.probability) for s in segs]


def test_binarize_matches_reference(vads, audio, probs):
    pv, _ = vads
    probs = probs[0]
    onset, offset = clear_thresholds(probs)
    for cfg in (p_model.VADConfig(), p_model.VADConfig(onset=onset, offset=offset),
                p_model.VADConfig(onset=onset, offset=offset, min_speech_duration=1.0,
                                  min_silence_duration=0.5)):
        jcfg = j_model.VADConfig(**dataclasses.asdict(cfg))
        assert (segments(p_model.binarize(probs, cfg))
                == segments(j_model.binarize(probs, jcfg)))
    segs = pv.detect_speech(audio, config=p_model.VADConfig(onset=onset, offset=offset))
    assert segs == p_model.binarize(probs, p_model.VADConfig(onset=onset, offset=offset))
    assert inspect.getsource(p_model.binarize) == inspect.getsource(j_model.binarize)


def _events(proc, audio, piece):
    out = []
    for i in range(0, len(audio), piece):
        out += proc.process(audio[i:i + piece])
    return out + proc.flush()


def test_streaming_processor_events_match_reference(vads, audio, probs):
    pv, jv = vads
    np.testing.assert_allclose(probs[0], probs[1], atol=1e-5, rtol=0)
    onset, offset = clear_thresholds(probs[0])
    cfg = dict(onset=onset, offset=offset, min_speech_duration=0.25, min_silence_duration=0.1)
    got = _events(p_stream.StreamingVADProcessor(pv, p_model.VADConfig(**cfg)), audio, 1600)
    want = _events(j_stream.StreamingVADProcessor(jv, j_model.VADConfig(**cfg)), audio, 1600)
    assert len(got) >= 4 and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.type.value == w.type.value and g.time == pytest.approx(w.time, abs=1e-9)
        assert (g.segment is None) == (w.segment is None)
        if g.segment is not None:
            assert (g.segment.start, g.segment.end) == pytest.approx((w.segment.start, w.segment.end))


def _mlx_checkpoint(params):
    """The MLX-converted layout the reference's ``convert_checkpoint`` reads."""
    flat = {"stft.weight": params["stft_basis"][:, :, None]}
    for i, conv in enumerate(params["encoder"]):
        flat[f"encoder.{i}.weight"] = np.ascontiguousarray(conv["kernel"].transpose(2, 0, 1))
        flat[f"encoder.{i}.bias"] = conv["bias"]
    flat["lstm.Wx"] = np.ascontiguousarray(params["lstm"]["wx"].T)
    flat["lstm.Wh"] = np.ascontiguousarray(params["lstm"]["wh"].T)
    flat["lstm.bias"] = params["lstm"]["bias"]
    flat["decoder.weight"] = np.ascontiguousarray(params["decoder"]["kernel"].transpose(2, 0, 1))
    flat["decoder.bias"] = params["decoder"]["bias"]
    return flat


def test_from_pretrained_safetensors_directory(params, audio, tmp_path):
    from safetensors.numpy import save_file

    save_file(_mlx_checkpoint(params), str(tmp_path / "model.safetensors"))
    pv = p_model.SileroVAD.from_pretrained(str(tmp_path), device="cpu")
    jv = j_model.SileroVAD.from_pretrained(str(tmp_path))
    x = audio[: 3 * SR]
    want = p_model.SileroVAD(params, device="cpu").speech_probabilities(x)
    np.testing.assert_array_equal(pv.speech_probabilities(x), want)
    np.testing.assert_allclose(jv.speech_probabilities(x), want, atol=1e-5, rtol=0)
    with pytest.raises(FileNotFoundError, match="offline mode: no cached snapshot for silero-vad-v5"):
        p_model.SileroVAD.from_pretrained("silero-vad-v5", device="cpu",
                                          cache_dir=str(tmp_path / "cache"), offline_mode=True)


class _Enc(torch.nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.reparam_conv = torch.nn.Conv1d(cin, cout, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reparam_conv(x)


class _Stft(torch.nn.Module):
    def __init__(self, basis):
        super().__init__()
        self.register_buffer("forward_basis_buffer", torch.from_numpy(basis[:, None, :]).clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _Dec(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.rnn = torch.nn.LSTMCell(128, 128)
        self.decoder = torch.nn.Sequential(torch.nn.Dropout(0.1), torch.nn.ReLU(),
                                           torch.nn.Conv1d(128, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _Inner(torch.nn.Module):
    def __init__(self, basis):
        super().__init__()
        self.stft = _Stft(basis)
        self.encoder = torch.nn.Sequential(_Enc(129, 128), _Enc(128, 64), _Enc(64, 64),
                                           _Enc(64, 128))
        self.decoder = _Dec()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _Upstream(torch.nn.Module):
    """The state-dict layout of the upstream Silero v5 TorchScript archive."""

    def __init__(self, params):
        super().__init__()
        self._model = _Inner(params["stft_basis"])
        with torch.no_grad():
            for conv, p in zip(self._model.encoder, params["encoder"]):
                conv.reparam_conv.weight.copy_(torch.from_numpy(p["kernel"].transpose(2, 1, 0)))
                conv.reparam_conv.bias.copy_(torch.from_numpy(p["bias"]))
            rnn = self._model.decoder.rnn
            rnn.weight_ih.copy_(torch.from_numpy(params["lstm"]["wx"].T))
            rnn.weight_hh.copy_(torch.from_numpy(params["lstm"]["wh"].T))
            rnn.bias_ih.copy_(torch.from_numpy(params["lstm"]["bias"]))
            rnn.bias_hh.zero_()
            head = self._model.decoder.decoder[2]
            head.weight.copy_(torch.from_numpy(params["decoder"]["kernel"].transpose(2, 1, 0)))
            head.bias.copy_(torch.from_numpy(params["decoder"]["bias"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def test_from_pretrained_torchscript_archive(params, audio, tmp_path):
    path = tmp_path / "silero_vad.jit"
    torch.jit.script(_Upstream(params)).save(str(path))
    got_tree, want_tree = p_model.convert_torchscript(path), j_model.convert_torchscript(path)
    import jax

    for g, w, src in zip(jax.tree_util.tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree),
                         jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, src)
    x = audio[: 2 * SR]
    for model_id in (str(path), str(tmp_path)):
        pv = p_model.SileroVAD.from_pretrained(model_id, device="cpu")
        np.testing.assert_array_equal(pv.speech_probabilities(x),
                                      p_model.SileroVAD(params, device="cpu").speech_probabilities(x))
