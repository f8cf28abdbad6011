"""Open-Unmix separation (``qwen3_asr_swift_tpu_torch/models/separation``)
against its JAX twin on the CPU.

Stem trees drawn with numpy at narrow hidden widths (the frequency axis
stays the published 2049 bins, cropped to 1487 where ``separate`` needs
it; every leaf jittered, so the norms, means and scales are not the
initializer's) go to both packages. Modules within 1e-5 of max
|reference| (fp32 both), whole outputs within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.separation import model as j_model
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.separation import model as p_model

TOL = 1e-5
WHOLE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The BiLSTM loop is a chain of small ops: with several test workers
    on the host, torch's intra-op threads only contend."""
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


def music(seconds=1.0, rate=44100, seed=0):
    """Stereo: a bass line, a lead and noise bursts, panned apart."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    bass = 0.3 * np.sin(2 * np.pi * 55 * t)
    lead = 0.2 * np.sin(2 * np.pi * 440 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
    hits = 0.1 * rng.standard_normal(len(t)) * ((t * 4) % 1 < 0.1)
    return np.stack([bass + 0.7 * lead + hits, bass + 0.3 * lead + hits]).astype(np.float32)


def stems_tree(nb_bins=1487, hidden=16, seed=0):
    rng = np.random.default_rng(seed)
    return {s: jitter(p_model.init_umx_params(rng, nb_bins=nb_bins, hidden=hidden),
                      np.random.default_rng(seed + 10 + i))
            for i, s in enumerate(p_model.STEMS)}


def test_stft_and_istft_match():
    x = music()
    n_frames = x.shape[1] // p_model.HOP + 1
    want = j_model.stft(jnp.asarray(x), n_frames)
    got = p_model.stft(torch.from_numpy(x), n_frames)
    for g, w in zip(got, want):
        close(g, w)
    re, im = (np.array(w) for w in want)
    back = p_model.istft(torch.from_numpy(re), torch.from_numpy(im), x.shape[1])
    close(back, j_model.istft(jnp.asarray(re), jnp.asarray(im), x.shape[1]))
    close(back, x, 1e-5)        # the inverse of the centred STFT


def test_overlap_add_equals_a_scatter_sum():
    """The four strided phase adds equal ``index_add_``'s scatter of every
    frame (exactly, on the host: each output sample has at most four terms
    and both add them from zero)."""
    frames = torch.randn((2, 7, p_model.N_FFT), generator=torch.Generator().manual_seed(0))
    got = p_model.overlap_add(frames)
    idx = (torch.arange(7)[:, None] * p_model.HOP + torch.arange(p_model.N_FFT)).reshape(-1)
    want = torch.zeros((2, 6 * p_model.HOP + p_model.N_FFT)).index_add_(
        1, idx, frames.reshape(2, -1))
    close(got, want, 1e-6)


def test_umx_forward_matches():
    """One stem at 64 input bins, hidden 16, on a real spectrogram: the
    estimate within 1e-5; the stacked-stems path row for row the same."""
    tree = stems_tree(nb_bins=64)
    x = music()
    re, im = p_model.stft(torch.from_numpy(x), x.shape[1] // p_model.HOP + 1)
    mag = torch.sqrt(re ** 2 + im ** 2).permute(1, 2, 0).contiguous()
    want = j_model.umx_forward(jax.tree_util.tree_map(jnp.asarray, tree["vocals"]),
                               jnp.asarray(mag.numpy()), nb_bins=64)
    port = {s: params_from_jax(t, "cpu", torch.float32) for s, t in tree.items()}
    got = p_model.umx_forward(port["vocals"], mag, nb_bins=64)
    close(got, want)
    both = p_model.umx_forward_stems(p_model.stack_stems([port["drums"], port["vocals"]]), mag,
                                     nb_bins=64)
    close(both[1], got, 1e-6)


def test_skip_width_is_cut_or_padded():
    """fc2's input narrower (cut) and wider (zero-padded) than the skip
    concat, as the reference allows."""
    x = music(0.5)
    re, im = p_model.stft(torch.from_numpy(x), x.shape[1] // p_model.HOP + 1)
    mag = torch.sqrt(re ** 2 + im ** 2).permute(1, 2, 0).contiguous()
    rng = np.random.default_rng(3)
    for fc2_in in (24, 40):
        tree = stems_tree(nb_bins=32, seed=5)["bass"]
        tree["fc2"]["kernel"] = (rng.standard_normal((fc2_in, 16)) * 0.2).astype(np.float32)
        want = j_model.umx_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                   jnp.asarray(mag.numpy()), nb_bins=32)
        got = p_model.umx_forward(params_from_jax(tree, "cpu", torch.float32), mag,
                                  nb_bins=32)
        close(got, want)


def test_wiener_masks_match():
    est = np.abs(np.random.default_rng(4).standard_normal((4, 5, 9, 2))).astype(np.float32)
    close(p_model.wiener_masks(torch.from_numpy(est)), j_model.wiener_masks(jnp.asarray(est)))


@pytest.fixture(scope="module")
def separators():
    tree = stems_tree()
    return (j_model.SourceSeparator({s: jax.tree_util.tree_map(jnp.asarray, t)
                                     for s, t in tree.items()}),
            p_model.SourceSeparator(tree, device="cpu"))


@pytest.mark.parametrize("stems", [None, ["bass", "vocals"]])
def test_separate_matches(separators, stems):
    """Stereo at 44.1 kHz, every stem or a subset in the caller's order:
    each stem within 1e-4."""
    ref, port = separators
    x = music(1.2)
    want = ref.separate(x, 44100, stems=stems)
    got = port.separate(x, 44100, stems=stems)
    assert list(got) == list(want) == (stems or list(p_model.STEMS))
    for s in got:
        close(got[s], want[s], WHOLE_TOL)
    assert port.last_loop == {"frames": x.shape[1] // 1024 + 1,
                              "iterations": 3 * (x.shape[1] // 1024 + 1)}


def test_separate_mono_resampled_matches(separators):
    """Mono 16 kHz input is duplicated to stereo and resampled to 44.1 kHz."""
    ref, port = separators
    mono = music(0.8, rate=16000)[0]
    want = ref.separate(mono, 16000, stems=["other"])
    got = port.separate(mono, 16000, stems=["other"])
    assert got["other"].shape == want["other"].shape == (2, 35280)
    close(got["other"], want["other"], WHOLE_TOL)


def test_defaults_and_checkpoint(tmp_path):
    """``init_random`` draws the published widths; per-stem files written
    here (``.pth`` through ``torch.load`` and ``.safetensors``) convert
    through the copied converter, each stem from its own file."""
    from safetensors.numpy import save_file

    m = p_model.SourceSeparator.init_random(device="cpu", stems=("vocals",))
    p = m.stem_params["vocals"]
    assert p["fc1"]["kernel"].shape == (2974, 512) and p["lstm_fwd"][2]["wh"].shape == (256, 1024)
    rng = np.random.default_rng(6)

    def state(scale):
        sd = {"input_mean": rng.standard_normal(1487), "input_scale": rng.uniform(0.5, 1.5, 1487),
              "output_scale": rng.uniform(0.5, 1.5, 2049), "output_mean": rng.standard_normal(2049),
              "fc1.weight": rng.standard_normal((16, 2974)) * 0.02,
              "fc2.weight": rng.standard_normal((16, 32)) * 0.2,
              "fc3.weight": rng.standard_normal((4098, 16)) * 0.2}
        for bn, c in (("bn1", 16), ("bn2", 16), ("bn3", 4098)):
            sd.update({f"{bn}.weight": rng.uniform(0.5, 1.5, c),
                       f"{bn}.bias": rng.standard_normal(c),
                       f"{bn}.running_mean": rng.standard_normal(c) * 0.1,
                       f"{bn}.running_var": rng.uniform(0.5, 1.5, c)})
        for layer in range(3):
            for sfx in ("", "_reverse"):
                sd[f"lstm.weight_ih_l{layer}{sfx}"] = rng.standard_normal((32, 16)) * 0.3
                sd[f"lstm.weight_hh_l{layer}{sfx}"] = rng.standard_normal((32, 8)) * 0.3
                sd[f"lstm.bias_ih_l{layer}{sfx}"] = rng.standard_normal(32) * 0.1
                sd[f"lstm.bias_hh_l{layer}{sfx}"] = rng.standard_normal(32) * 0.1
        return {k: np.asarray(v, np.float32) * (scale if k == "fc3.weight" else 1)
                for k, v in sd.items()}

    vocals, bass = state(1.0), state(0.5)
    torch.save({k: torch.from_numpy(v) for k, v in vocals.items()},
               tmp_path / "vocals-b62c91ce.pth")
    save_file(bass, str(tmp_path / "bass-8d85a5bd.safetensors"))
    port = p_model.SourceSeparator.from_pretrained(str(tmp_path), device="cpu")
    assert sorted(port.stem_params) == ["bass", "vocals"]
    from qwen3_asr_swift_tpu.models.separation.convert import load_umx_checkpoint

    ref = j_model.SourceSeparator(load_umx_checkpoint(tmp_path))
    x = music(0.5)
    want, got = ref.separate(x, 44100), port.separate(x, 44100)
    for s in ("vocals", "bass"):
        close(got[s], want[s], WHOLE_TOL)
