"""MADLAD-400 translation (``qwen3_asr_swift_tpu_torch/models/translation``)
against its JAX twin on the CPU.

The relative-position buckets are computed on the host with numpy; they
equal the reference's at every relative position in [-1024, 1024], both
directions, and at every decoder offset up to 128. One numpy-drawn tree
at ``config_tiny()`` goes to both packages: the encoder and a decode step
within 1e-5 of max |reference| (fp32 both), the greedy ids identical,
with an EOS stop (rows done at different steps, later writes pad) and a
``max_new`` cut.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.translation import model as j_model
from qwen3_asr_swift_tpu_torch.models.translation import model as p_model

TOL = 1e-5
CFG = p_model.config_tiny()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The decode loop is a chain of small ops: with several test workers
    on the host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jcfg(cfg):
    return j_model.T5Config(**dataclasses.asdict(cfg))


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err
    return err


@pytest.mark.parametrize("bidirectional", [True, False])
def test_buckets_equal_over_the_whole_range(bidirectional):
    rel = np.arange(-1024, 1025)
    want = np.asarray(j_model.relative_position_bucket(jnp.asarray(rel), bidirectional, 32, 128))
    np.testing.assert_array_equal(p_model.relative_position_bucket(rel, bidirectional, 32, 128),
                                  want)


def test_decoder_biases_equal_at_every_offset():
    """A table with one distinct value a bucket: the port's bias rows equal
    the reference's ``rel_bias`` at each decoder offset 0..128 (and the
    encoder's bidirectional square)."""
    table = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
    cfg = jcfg(CFG)
    for step in range(129):
        want = j_model.rel_bias(jnp.asarray(table), 1, 160, False, cfg, q_offset=step)
        got = p_model.rel_bias(torch.from_numpy(table),
                               p_model.bucket_table(1, 160, False, 32, 128, q_offset=step))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = p_model.bucket_table(129, 129, False, 32, 128)
    for step in (0, 57, 128):
        np.testing.assert_array_equal(rows[step],
                                      p_model.bucket_table(1, 129, False, 32, 128, step)[0])
    want = j_model.rel_bias(jnp.asarray(table), 48, 48, True, cfg)
    got = p_model.rel_bias(torch.from_numpy(table), p_model.bucket_table(48, 48, True, 32, 128))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def tree():
    tree = p_model.init_t5_params(np.random.default_rng(0), CFG)
    rng = np.random.default_rng(1)
    for layers in (tree["encoder"], tree["decoder"]):
        for p in layers:
            for k in ("ln1", "ln2", "ln3"):
                if k in p:
                    p[k]["weight"] = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models(tree):
    return (j_model.MADLADTranslator(jcfg(CFG), jax.tree_util.tree_map(jnp.asarray, tree)),
            p_model.MADLADTranslator(CFG, tree, device="cpu"))


def source(n, seed=2):
    return np.random.default_rng(seed).integers(2, 128, n).tolist()


def test_encoder_and_step_match(models):
    """Encoder output of a 13-id source in a 16 bucket, then three decode
    steps on the reference's cache: logits within 1e-5."""
    ref, port = models
    ids = source(13)
    arr, valid = port.prepare(ids)
    j_arr, j_valid = jnp.asarray(arr.numpy().astype(np.int32)), jnp.asarray(valid.numpy())
    want = j_model.t5_encode(ref.params, jcfg(CFG), j_arr, j_valid)
    got = p_model.t5_encode(port.params, CFG, arr, valid)
    close(got, want)
    max_new = 6
    kv = [(jnp.zeros((1, 4, max_new, 8)), jnp.zeros((1, 4, max_new, 8))) for _ in range(2)]
    pkv = [(torch.zeros((1, 4, max_new, 8)), torch.zeros((1, 4, max_new, 8))) for _ in range(2)]
    enc_kv = p_model.cross_kv(port.params, CFG, got)
    biases = p_model.decoder_bias(port.params, CFG, max_new)
    enc_bias = p_model._pad_bias(valid)
    tok = [0, 17, 93]
    for step, t in enumerate(tok):
        w, kv = j_model.t5_decode_step(ref.params, jcfg(CFG), jnp.asarray([t], jnp.int32), want,
                                       j_valid, kv, step)
        g = p_model.t5_decode_step(port.params, CFG, torch.tensor([t]), enc_kv, enc_bias, pkv,
                                   step, biases[step])
        close(g, w)
        close(pkv[1][0], kv[1][0])


def twins(models, **changes):
    """Both packages' translators on the shared weights under another
    config."""
    cfg = dataclasses.replace(CFG, **changes)
    ref, port = models
    p = p_model.MADLADTranslator(cfg, {}, device="cpu")
    p.params = port.params
    return j_model.MADLADTranslator(jcfg(cfg), ref.params), p


def free_ids(port, ids, max_new):
    """The raw ids a run with EOS out of reach emits."""
    arr, valid = port.prepare(ids)
    cfg = dataclasses.replace(port.cfg, eos_token_id=10 ** 6)
    return p_model.greedy_translate(port.params, cfg, arr, valid, max_new)[0][0].tolist()


def first_new(ids, start=1):
    """The first step from ``start`` whose id is new and not pad (step 0
    where the run repeats one id)."""
    return next((k for k in range(start, len(ids)) if ids[k] not in ids[:k] and ids[k] != 0), 0)


@pytest.mark.parametrize("n", [5, 16, 21])
def test_greedy_ids_identical(models, n):
    """``translate_ids`` equals the reference's ids: with the config's EOS;
    with EOS out of reach (the ``max_new`` cut at 20: the flags read at
    steps 8 and 16); with EOS set to the first new id the free run emits,
    or its first id where it repeats one (the stop, before the first read
    at step 8)."""
    ref, port = models
    ids = source(n, seed=n)
    assert port.translate_ids(ids, max_new=20) == ref.translate_ids(ids, max_new=20)
    j, p = twins(models, eos_token_id=10 ** 6)
    got = p.translate_ids(ids, max_new=20)
    assert got == j.translate_ids(ids, max_new=20)
    assert p.last_loop == {"steps": 20, "reads": 2}
    free = free_ids(port, ids, 12)
    k = first_new(free)
    assert k < 8
    j, p = twins(models, eos_token_id=free[k])
    got = p.translate_ids(ids, max_new=12)
    assert got == j.translate_ids(ids, max_new=12) == [t for t in free[:k] if t != 0]
    assert p.last_loop == {"steps": 8, "reads": 1}


def test_batch_rows_stop_at_their_own_eos(models):
    """Two rows whose EOS come at different steps: each row of the port's
    batch (pad after the row's EOS, the done flags read every 8 steps)
    equals the reference's ``while_loop`` on that row alone."""
    ref, port = models
    rows = [source(9, 31), source(12, 32)]
    free = free_ids(port, rows[0], 16)
    eos = free[first_new(free, 2)]
    j, p = twins(models, eos_token_id=eos)
    arr = np.zeros((2, 16), np.int64)
    valid = np.zeros((2, 16), bool)
    for i, r in enumerate(rows):
        arr[i, :len(r)], valid[i, :len(r)] = r, True
    got, steps, reads = p_model.greedy_translate(p.params, p.cfg, torch.from_numpy(arr),
                                                 torch.from_numpy(valid), 16)
    for i in range(2):
        want = np.asarray(j._translate_jit(j.params, jnp.asarray(arr[i:i + 1], jnp.int32),
                                           jnp.asarray(valid[i:i + 1]), t_bucket=16, max_new=16))
        np.testing.assert_array_equal(got[i:i + 1].numpy(), want)
    assert (got.numpy()[0] == eos).any()
    assert (steps, reads) in ((8, 1), (16, 1))


def test_reference_decode_fails_past_batch_one(models):
    """A fault of the reference: its decode step's self-attention bias is
    [1, heads, 1, L] and ``sdpa`` reshapes a per-head mask by the batch, so
    ``_translate`` raises for two rows. (``translate_ids`` runs one row, so
    the reference's own paths never reach it.)"""
    ref, _ = models
    arr = jnp.asarray(np.full((2, 16), 5, np.int32))
    with pytest.raises(TypeError, match="reshape"):
        ref._translate_jit(ref.params, arr, jnp.ones((2, 16), bool), t_bucket=16, max_new=4)


def test_translate_adds_the_prefix_and_eos(tmp_path, models):
    """``translate`` encodes ``<2xx> text`` with the SentencePiece reader and
    appends EOS, as the reference does; both packages give one string."""
    from qwen3_asr_swift_tpu.tokenizers.sentencepiece_model import SentencePieceModel as JSPM
    from qwen3_asr_swift_tpu_torch.tokenizers.sentencepiece_model import SentencePieceModel

    from test_torch_vendored import _sp_model

    path = tmp_path / "sp.model"
    _sp_model(path)
    ref, port = models
    ref.tokenizer, port.tokenizer = JSPM.load(path), SentencePieceModel.load(path)
    try:
        want = ref.translate("hello world", target_lang="de", max_new=6)
        assert port.translate("hello world", target_lang="de", max_new=6) == want
        assert next(port.translate_stream("hello world", "de", max_new=6)) == want
    finally:
        ref.tokenizer = port.tokenizer = None
    with pytest.raises(RuntimeError, match="tokenizer"):
        port.translate("hi")


def test_from_pretrained_loads_bf16(tmp_path, tree):
    """An HF T5 checkpoint written here at the tiny widths loads through the
    copied converter (its depth is the 3B's, so only the converter is run
    here) in bf16, as the reference loads it."""
    from qwen3_asr_swift_tpu_torch.models.translation import convert

    flat = {"shared.weight": tree["shared"], "lm_head.weight": tree["lm_head"]["kernel"].T,
            "encoder.final_layer_norm.weight": np.ones(32, np.float32),
            "decoder.final_layer_norm.weight": np.ones(32, np.float32),
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": tree["enc_rel"],
            "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": tree["dec_rel"]}
    for i, p in enumerate(tree["encoder"]):
        b = f"encoder.block.{i}.layer"
        flat[f"{b}.0.layer_norm.weight"], flat[f"{b}.1.layer_norm.weight"] = (
            p["ln1"]["weight"], p["ln2"]["weight"])
        for k in "qkvo":
            flat[f"{b}.0.SelfAttention.{k}.weight"] = p["attn"][k]["kernel"].T
        for k in ("wi_0", "wi_1", "wo"):
            flat[f"{b}.1.DenseReluDense.{k}.weight"] = p["ffn"][k]["kernel"].T
    for i, p in enumerate(tree["decoder"]):
        b = f"decoder.block.{i}.layer"
        for j, k in enumerate(("ln1", "ln2", "ln3")):
            flat[f"{b}.{j}.layer_norm.weight"] = p[k]["weight"]
        for k in "qkvo":
            flat[f"{b}.0.SelfAttention.{k}.weight"] = p["self_attn"][k]["kernel"].T
            flat[f"{b}.1.EncDecAttention.{k}.weight"] = p["cross_attn"][k]["kernel"].T
        for k in ("wi_0", "wi_1", "wo"):
            flat[f"{b}.2.DenseReluDense.{k}.weight"] = p["ffn"][k]["kernel"].T
    params = convert.convert_t5_checkpoint({k: np.ascontiguousarray(v) for k, v in flat.items()},
                                           CFG)
    m = p_model.MADLADTranslator(CFG, params, dtype=torch.bfloat16, device="cpu")
    assert m.params["decoder"][1]["ffn"]["wo"]["kernel"].dtype == torch.bfloat16
    ids = source(7)
    want = p_model.MADLADTranslator(CFG, tree, device="cpu").translate_ids(ids, max_new=4)
    assert len(m.translate_ids(ids, max_new=4)) <= 4 and len(want) <= 4
    import inspect

    sig = inspect.signature(p_model.MADLADTranslator.from_pretrained)
    assert sig.parameters["dtype"].default == torch.bfloat16
    with pytest.raises(FileNotFoundError, match="offline mode: no cached snapshot for google/madlad"):
        p_model.MADLADTranslator.from_pretrained(device="cpu", cache_dir=str(tmp_path / "cache"),
                                                 offline_mode=True)
