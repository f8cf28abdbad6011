"""Speaker embedding (``qwen3_asr_swift_tpu_torch/models/speaker``):
WeSpeaker ResNet34 and CAM++ against their JAX twins on the CPU, and
``CosyVoiceTTS.clone_voice`` with a CAM++ twin.

One numpy-drawn tree a model (batch-norm leaves jittered, so the norms are
not the initializer's identity) goes to both packages. Modules within
1e-5 of max |reference| (fp32 both), whole embeddings within 1e-4, the
``ValueError``s alike.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.speaker import campplus as j_cam
from qwen3_asr_swift_tpu.models.speaker import model as j_wes
from qwen3_asr_swift_tpu_torch.models.speaker import campplus as p_cam
from qwen3_asr_swift_tpu_torch.models.speaker import model as p_wes

TOL = 1e-5
WHOLE_TOL = 1e-4
WES_WIDTHS = dict(embed_dim=16, channels=(4, 8, 8, 8), blocks=(1, 2, 1, 1))
CAM_CFG = p_cam.config_tiny()
J_CAM_CFG = j_cam.CampPlusConfig(**dataclasses.asdict(CAM_CFG))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Chains of small convs: with several test workers on the host,
    torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jitter_norms(tree, rng, keys=("scale", "bias", "mean", "b")):
    if isinstance(tree, dict):
        return {k: (jitter_norms(v, rng, keys) if isinstance(v, (dict, list)) else
                    (v + 0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
                    if k in keys else v) for k, v in tree.items()}
    return [jitter_norms(v, rng, keys) for v in tree]


def widen_var(tree, rng):
    if isinstance(tree, dict):
        return {k: (widen_var(v, rng) if isinstance(v, (dict, list)) else
                    rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32) if k == "var" else v)
                for k, v in tree.items()}
    return [widen_var(v, rng) for v in tree]


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err
    return err


def voice(n, f0=150.0, seed=0, rate=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    wave = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 6))
    return (0.2 * wave + 0.01 * rng.standard_normal(n)).astype(np.float32)


# -- WeSpeaker ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def wes():
    tree = jitter_norms(p_wes.init_wespeaker_params(np.random.default_rng(0), **WES_WIDTHS),
                        np.random.default_rng(1))
    return (j_wes.WeSpeaker(jax.tree_util.tree_map(jnp.asarray, tree)),
            p_wes.WeSpeaker(tree, device="cpu"))


def test_wespeaker_forward_matches(wes):
    """The ResNet and the stats pool over a padded fbank, the valid edge
    inside the padding: within 1e-5."""
    ref, port = wes
    fb = np.random.default_rng(2).standard_normal((70, 80)).astype(np.float32)
    want = j_wes.wespeaker_forward(ref.params, jnp.asarray(fb), 53)
    got = p_wes.wespeaker_forward(port.params, torch.from_numpy(fb)[None], torch.tensor([53]))
    close(got[0], want)


@pytest.mark.parametrize("n", [21920, 31500, 40000, 80000])
def test_wespeaker_embed_matches(wes, n):
    """Clips whose valid edge sits inside their bucket (1.37 s and 1.97 s in
    2 s, 2.5 s in 5 s) and at it (5 s): the normalised embedding within
    1e-4."""
    ref, port = wes
    audio = voice(n)
    close(port.embed(audio), ref.embed(audio), WHOLE_TOL)


def test_wespeaker_bucket_is_part_of_the_function(wes):
    """A clip that nearly fills its 2 s bucket, padded to 5 s instead,
    embeds otherwise: past the first conv the padded frames are no longer
    zero, and the convs at the last valid frames read them where the 2 s
    bucket's edge gives the convs' own zero padding. So the port pads as
    the reference does. (Far from the bucket's edge the two agree.)"""
    _, port = wes
    for n, differs in ((31500, True), (21920, False)):
        stage = np.zeros((1, 80000), np.float32)
        stage[0, :n] = voice(n)
        own = port.embed_raw(stage[:, :32000], np.asarray([n]))[0].numpy()
        longer = port.embed_raw(stage, np.asarray([n]))[0].numpy()
        assert (np.abs(own - longer).max() > 1e-3 * np.abs(own).max()) == differs, n


def test_wespeaker_embed_batch_matches(wes):
    """Clips of three lengths share the largest clip's bucket, as the
    reference's vmap puts them: rows within 1e-4 of its ``embed_batch``;
    clips of one bucket row for row within 1e-5 of ``embed``."""
    ref, port = wes
    clips = [voice(n, f0, i) for i, (n, f0) in enumerate(((24000, 120), (9000, 200),
                                                          (50000, 150)))]
    close(port.embed_batch(clips), ref.embed_batch(clips), WHOLE_TOL)
    same = [voice(n, 130 + 20 * i, i) for i, n in enumerate((24000, 20000, 31000))]
    batch = port.embed_batch(same)
    for i, c in enumerate(same):
        close(batch[i], port.embed(c))
    assert port.embed_batch([]).shape == (0, 16)
    close(port.embed(voice(16000)[::2].copy(), 8000), ref.embed(voice(16000)[::2].copy(), 8000),
          WHOLE_TOL)


def test_wespeaker_defaults_are_the_published_widths():
    tree = p_wes.init_wespeaker_params(np.random.default_rng(0))
    assert [len(s) for s in tree["stages"]] == [3, 4, 6, 3]
    assert tree["stages"][3][0]["conv1"]["kernel"].shape == (3, 3, 128, 256)
    assert tree["embed"]["kernel"].shape == (256 * 10 * 2, 256)
    m = p_wes.WeSpeaker.init_random(device="cpu")
    assert m.embed_dim == 256 and len(m.params["stages"][2]) == 6


def test_wespeaker_from_pretrained_reads_a_local_checkpoint(tmp_path, wes):
    """A wespeaker-named state dict written here (OIHW with [freq, time]
    axes, running stats) converts through the copied converter."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(5)
    flat = {}

    def conv(name, kh, kw, cin, cout):
        flat[f"{name}.weight"] = rng.standard_normal((cout, cin, kw, kh)).astype(np.float32) * 0.3

    def bn(name, c):
        flat[f"{name}.weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        flat[f"{name}.bias"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
        flat[f"{name}.running_mean"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
        flat[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    ch, blocks = (4, 8, 8, 8), (3, 4, 6, 3)
    conv("front.conv1", 3, 3, 1, ch[0])
    bn("front.bn1", ch[0])
    cin = ch[0]
    for si, (c, nb) in enumerate(zip(ch, blocks)):
        for bi in range(nb):
            base = f"layer{si + 1}.{bi}"
            conv(f"{base}.conv1", 3, 3, cin, c)
            bn(f"{base}.bn1", c)
            conv(f"{base}.conv2", 3, 3, c, c)
            bn(f"{base}.bn2", c)
            if bi == 0 and (si > 0 or cin != c):
                conv(f"{base}.downsample.0", 1, 1, cin, c)
                bn(f"{base}.downsample.1", c)
            cin = c
    flat["seg_1.weight"] = rng.standard_normal((12, 8 * 10 * 2)).astype(np.float32) * 0.05
    flat["seg_1.bias"] = np.zeros(12, np.float32)
    save_file(flat, str(tmp_path / "model.safetensors"))
    port = p_wes.WeSpeaker.from_pretrained(str(tmp_path), device="cpu")
    from qwen3_asr_swift_tpu.core.weights import load_safetensors
    from qwen3_asr_swift_tpu.models.speaker.convert import convert_wespeaker

    ref = j_wes.WeSpeaker(convert_wespeaker(load_safetensors(tmp_path)))
    close(port.embed(voice(24000)), ref.embed(voice(24000)), WHOLE_TOL)


# -- CAM++ --------------------------------------------------------------------------

def cam_tree(cfg=CAM_CFG, seed=0):
    rng = np.random.default_rng(seed + 1)
    return widen_var(jitter_norms(p_cam.init_campplus_params(np.random.default_rng(seed), cfg),
                                  rng), rng)


@pytest.fixture(scope="module")
def cam():
    tree = cam_tree()
    return (j_cam.CampPlusSpeaker(J_CAM_CFG, jax.tree_util.tree_map(jnp.asarray, tree)),
            p_cam.CampPlusSpeaker(CAM_CFG, tree, device="cpu"))


@pytest.mark.parametrize("n_valid", [None, 13000])
def test_campplus_fbank_matches(n_valid):
    """Povey window, pre-emphasis, the 512-point DFT, Slaney-normalised HTK
    mels, log floor and CMN (over the valid rows when given)."""
    audio = voice(16000, seed=3)
    want = j_cam.campplus_fbank(jnp.asarray(audio), None if n_valid is None else
                                jnp.asarray(n_valid, jnp.int32), J_CAM_CFG)
    got = p_cam.campplus_fbank(torch.from_numpy(audio), n_valid, CAM_CFG)
    close(got, want, 1e-4)     # log-mels near zero after CMN: held to the largest
    stage = np.stack([audio, np.pad(audio[:9000], (0, 7000))])
    rows = p_cam.campplus_fbank(torch.from_numpy(stage), np.asarray([16000, 9000]), CAM_CFG)
    want = j_cam.campplus_fbank(jnp.asarray(stage[1]), jnp.asarray(9000), J_CAM_CFG)
    close(rows[1, :54], want[:54], 1e-4)
    assert (rows[1, 54:] == 0).all()


def test_prepare_frames_tiles_and_crops():
    mel = np.arange(14 * 3, dtype=np.float32).reshape(14, 3)
    for target in (5, 14, 40):
        np.testing.assert_array_equal(p_cam.prepare_frames(mel, target),
                                      j_cam.prepare_frames(mel, target))
    np.testing.assert_array_equal(p_cam.prepare_frames(mel, 6), mel[4:10])
    np.testing.assert_array_equal(p_cam.prepare_frames(mel, 30)[14:28], mel)


def test_campplus_layers_match(cam):
    """The FCM head's NCHW convs, a dense layer with its dilated CAM conv and
    the ceil-mode segment pool (its last segment shorter), within 1e-5."""
    ref, port = cam
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((23, 16)).astype(np.float32)
    close(p_cam._fcm(port.params["head"], torch.from_numpy(mel)[None]),
          j_cam._fcm(ref.params["head"], jnp.asarray(mel)))
    x = rng.standard_normal((2, 8, 23)).astype(np.float32)
    close(p_cam._seg_pool(torch.from_numpy(x), 5), j_cam._seg_pool(jnp.asarray(x), 5))
    layer_j, layer_p = ref.params["blocks"][1][1], port.params["blocks"][1][1]
    x = rng.standard_normal((1, layer_p["nonlinear1"]["mean"].shape[0], 23)).astype(np.float32)
    close(p_cam._dense_layer(torch.from_numpy(x), layer_p, CAM_CFG, 2),
          j_cam._dense_layer(jnp.asarray(x), layer_j, J_CAM_CFG, 2))


def test_campplus_forward_matches(cam):
    ref, port = cam
    mel = np.random.default_rng(6).standard_normal((40, 16)).astype(np.float32)
    want = j_cam.campplus_forward(ref.params, J_CAM_CFG, jnp.asarray(mel))
    got = p_cam.campplus_forward(port.params, CAM_CFG, torch.from_numpy(mel)[None])
    close(got[0], want)


def test_campplus_embed_and_batch_match(cam):
    """``embed`` of a short clip (tiled) and a long one (cropped), and a
    batch of three lengths: within 1e-4 of the reference; batch rows within
    1e-5 of ``embed``."""
    ref, port = cam
    clips = [voice(n, f0, i) for i, (n, f0) in enumerate(((4000, 110), (16000, 170),
                                                          (40000, 230)))]
    for c in clips:
        close(port.embed(c), ref.embed(c), WHOLE_TOL)
    batch = port.embed_batch(clips)
    close(batch, ref.embed_batch(clips), WHOLE_TOL)
    for i, c in enumerate(clips):
        close(batch[i], port.embed(c))
    assert port.embed_batch([]).shape == (0, CAM_CFG.embedding_size)


@pytest.mark.parametrize("n,match", [(1500, "too short"), (1700, "Too few mel frames")])
def test_campplus_value_errors(cam, n, match):
    for model in cam:
        with pytest.raises(ValueError, match=match):
            model.embed(np.zeros(n, np.float32))
        with pytest.raises(ValueError, match=match):
            model.embed_batch([voice(16000), np.zeros(n, np.float32)])


def test_campplus_defaults():
    assert p_cam.CampPlusSpeaker.init_random(device="cpu").cfg == CAM_CFG
    tree = p_cam.init_campplus_params(np.random.default_rng(0), p_cam.CONFIG_CAMPPLUS)
    assert [len(b) for b in tree["blocks"]] == [12, 24, 16]
    assert tree["dense"]["linear"]["w"].shape == (192, 1024, 1)


# -- clone_voice ----------------------------------------------------------------------

def export_campplus(tree) -> dict:
    """The inverse of the copied converter: a tree → 3D-Speaker names."""
    flat = {}

    def bn(name, p):
        flat[f"{name}.running_mean"], flat[f"{name}.running_var"] = p["mean"], p["var"]
        if "scale" in p:
            flat[f"{name}.weight"], flat[f"{name}.bias"] = p["scale"], p["bias"]

    def c1(name, p):
        flat[f"{name}.weight"] = p["w"]
        if "b" in p:
            flat[f"{name}.bias"] = p["b"]

    head = tree["head"]
    flat["head.conv1.weight"], flat["head.conv2.weight"] = head["conv1"], head["conv2"]
    bn("head.bn1", head["bn1"])
    bn("head.bn2", head["bn2"])
    for layer in ("layer1", "layer2"):
        for i, blk in enumerate(head[layer]):
            base = f"head.{layer}.{i}"
            flat[f"{base}.conv1.weight"], flat[f"{base}.conv2.weight"] = blk["conv1"], blk["conv2"]
            bn(f"{base}.bn1", blk["bn1"])
            bn(f"{base}.bn2", blk["bn2"])
            if "shortcut_w" in blk:
                flat[f"{base}.shortcut.0.weight"] = blk["shortcut_w"]
                bn(f"{base}.shortcut.1", blk["shortcut_bn"])
    c1("xvector.tdnn.linear", tree["tdnn"]["linear"])
    bn("xvector.tdnn.nonlinear.batchnorm", tree["tdnn"]["nonlinear"])
    for b, (block, tr) in enumerate(zip(tree["blocks"], tree["transits"]), start=1):
        for j, layer in enumerate(block, start=1):
            base = f"xvector.block{b}.tdnnd{j}"
            bn(f"{base}.nonlinear1.batchnorm", layer["nonlinear1"])
            flat[f"{base}.linear1.weight"] = layer["linear1"]
            bn(f"{base}.nonlinear2.batchnorm", layer["nonlinear2"])
            for k in ("linear_local", "linear1", "linear2"):
                c1(f"{base}.cam_layer.{k}", layer["cam"][k])
        bn(f"xvector.transit{b}.nonlinear.batchnorm", tr["nonlinear"])
        flat[f"xvector.transit{b}.linear.weight"] = tr["linear"]
    bn("xvector.out_nonlinear.batchnorm", tree["out_nonlinear"])
    c1("xvector.dense.linear", tree["dense"]["linear"])
    bn("xvector.dense.nonlinear.batchnorm", tree["dense"]["nonlinear"])
    return {k: np.ascontiguousarray(v, np.float32) for k, v in flat.items()}


def test_clone_voice_with_a_campplus_twin(cam):
    """Each package's CosyVoice clones a voice with its own CAM++ twin: the
    stored vectors within 1e-4, and equal to the port's ``embed``."""
    from qwen3_asr_swift_tpu.models.cosyvoice import CosyVoiceTTS as JCosy
    from qwen3_asr_swift_tpu.models.cosyvoice import config_tiny as j_cosy_tiny
    from qwen3_asr_swift_tpu_torch.models.cosyvoice import CosyVoiceTTS, config_tiny
    from qwen3_asr_swift_tpu_torch.models.cosyvoice.model import init_cosyvoice_params

    ref_spk, port_spk = cam
    audio = voice(24000, 140, 7)
    tree = init_cosyvoice_params(np.random.default_rng(0), config_tiny())
    ref = JCosy(j_cosy_tiny(), jax.tree_util.tree_map(jnp.asarray, tree))
    port = CosyVoiceTTS(config_tiny(), tree, device="cpu")
    ref.clone_voice("alice", audio, 16000, speaker_model=ref_spk)
    port.clone_voice("alice", audio, 16000, speaker_model=port_spk)
    got, want = port.voices["alice"].embedding, ref.voices["alice"].embedding
    close(got, want, WHOLE_TOL)
    n = config_tiny().flow.spk_embed_dim
    np.testing.assert_array_equal(got, port_spk.embed(audio)[:n])


def test_clone_voice_loads_campplus_from_pretrained(tmp_path, monkeypatch):
    """Without a speaker model, ``clone_voice`` loads CAM++ with
    ``from_pretrained()``'s default id on the model's device, as the
    reference does: a CAM++ checkpoint exported here under that id (a local
    directory) gives the vector of a ``CampPlusSpeaker`` built from the same
    weights."""
    from safetensors.numpy import save_file

    from qwen3_asr_swift_tpu_torch.models.cosyvoice import CosyVoiceTTS, config_tiny

    tree = cam_tree(seed=3)
    model_dir = tmp_path / "aufklarer" / "CamPlusPlus-Speaker-CoreML"
    os.makedirs(model_dir)
    save_file(export_campplus(tree), str(model_dir / "campplus.safetensors"))
    monkeypatch.chdir(tmp_path)
    port = CosyVoiceTTS.init_random(config_tiny(), device="cpu")
    audio = voice(20000, 160, 8)
    port.clone_voice("bob", audio)
    loaded = p_cam.CampPlusSpeaker.from_pretrained(device="cpu")
    assert loaded.cfg == dataclasses.replace(p_cam.CONFIG_CAMPPLUS, feat_dim=16, embedding_size=8,
                                             growth_rate=4, bn_size=2, init_channels=8,
                                             m_channels=4, block_layers=(2, 2),
                                             block_dilations=(1, 2))
    direct = p_cam.CampPlusSpeaker(loaded.cfg, tree, device="cpu")
    n = config_tiny().flow.spk_embed_dim
    np.testing.assert_array_equal(port.voices["bob"].embedding, direct.embed(audio)[:n])
    monkeypatch.chdir(tmp_path / "aufklarer")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("QWEN3_CACHE_DIR", str(tmp_path / "cache"))
    with pytest.raises(FileNotFoundError, match="offline mode: no cached snapshot for "
                                                "aufklarer/CamPlusPlus"):
        port.clone_voice("carol", audio)
