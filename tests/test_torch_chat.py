"""The port's Qwen3.5 chat against the JAX package's, on the CPU.

Both packages take the same numpy weights (drawn by the port's
initialiser), the model in fp32:

- ``deltanet_forward``, ``gated_attention_forward`` and ``chat_forward``
  within 1e-5 of max |ref|, with pad steps, dense and packed 4-bit (at
  hidden 128 and intermediate 256, as ``tests/test_chat.py`` widens
  ``config_tiny``) with the embedding dense, so the activations stay fp32;
- prefill then decode equal to one long forward, and left-pad invariance;
- greedy ``generate_ids`` and ``generate_ids_stream`` tokens identical to
  the reference's, dense and packed; with the embedding table packed too
  (the reference's ``quantize_tree``: bf16 activations, K1 on the tied
  head) the tokens are the reference's up to the first parting, the logits
  of every step up to and at it within 0.1 relative L2 of the reference's
  and no farther than the reference's from an fp32 evaluation, and the
  parting only at a near-tie: the largest logit difference there within
  0.15 of max |ref|, and the reference's margin between the two tokens
  within twice that difference;
- ``chat_sample``: greedy with and without the penalty identical to the
  reference's; sampled draws held in distribution (a ``torch.Generator``
  cannot reproduce ``jax.random``);
- ``apply_chat_template``, ``chat`` through ``StreamingDecoder``;
- the converter leaf for leaf on a checkpoint the test writes (MLX-packed
  linears, dense tables), and ``from_pretrained(dir)`` tokens equal to the
  reference's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_asr_swift_tpu.models.chat import Qwen3Chat as JaxChat
from qwen3_asr_swift_tpu.models.chat import chat_sample as jax_chat_sample
from qwen3_asr_swift_tpu.models.chat import convert as jconvert
from qwen3_asr_swift_tpu.models.chat import model as jm
from qwen3_asr_swift_tpu.ops import quant as jquant
from qwen3_asr_swift_tpu_torch.cli import chat_tokenizer
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax, quantize_tree_np
from qwen3_asr_swift_tpu_torch.models.chat import ChatSamplingConfig, Qwen3Chat, chat_sample
from qwen3_asr_swift_tpu_torch.models.chat import convert as pconvert
from qwen3_asr_swift_tpu_torch.models.chat import model as pm

TOL = 1e-5
TINY = pm.config_tiny()
WIDE = dataclasses.replace(TINY, hidden_size=128, intermediate_size=256)
PROMPT = [3, 5, 7, 11, 13]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jcfg(cfg):
    return jm.ChatConfig(**dataclasses.asdict(cfg))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def pair(cfg, quant_bits=None, embed_keys=("embed_tokens",), seed=0, **kw):
    """(port model, reference model) on the same numpy weights, fp32."""
    params = pm.init_chat_params(np.random.default_rng(seed), cfg)
    ref_params = quantize_tree_np(params, quant_bits, embed_keys=embed_keys) if quant_bits \
        else params
    port = Qwen3Chat(cfg, ref_params, device="cpu", **kw)
    return port, JaxChat(jcfg(cfg), jtree(ref_params), **kw)


@pytest.fixture(scope="module")
def dense():
    return pair(TINY)


@pytest.fixture(scope="module")
def packed():
    """Packed linears, dense embedding: fp32 activations."""
    return pair(WIDE, quant_bits=4, embed_keys=())


def inputs(b=2, t=7, seed=1):
    ids = np.random.default_rng(seed).integers(0, 250, (b, t))
    valid = np.ones((b, t), bool)
    valid[1, :3] = False
    pos = np.maximum(np.cumsum(valid, 1) - 1, 0)
    return ids, valid, pos


def cpu_states(cfg, batch, max_len):
    """The port's zero states on the CPU (its default device is the card)."""
    return pm.init_states(cfg, batch, max_len, device="cpu")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_states_default_to_the_card():
    """The zero states follow the package's device rule: the card unless
    the caller passes the CPU (on a machine without a card that raises)."""
    cfg = pm.config_tiny()
    states = cpu_states(cfg, 1, 4)
    assert all(t.device.type == "cpu" for st in states for t in st if torch.is_tensor(t))
    assert pm.init_deltanet_state(cfg, 1, device="cpu")[0].device.type == "cpu"
    if not torch.cuda.is_available():
        for make in (lambda: pm.init_states(cfg, 1, 4), lambda: pm.init_deltanet_state(cfg, 1)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()


@pytest.mark.parametrize("which", ["dense", "packed"])
def test_layers_and_forward_match(which, request):
    port, ref = request.getfixturevalue(which)
    cfg = port.cfg
    ids, valid, pos = inputs()
    x = np.random.default_rng(2).standard_normal((2, 7, cfg.hidden_size)).astype(np.float32)
    for i in (0, cfg.full_attention_interval - 1):
        pj, pp = ref.params["layers"][i], port.params["layers"][i]
        js, ps = jm.init_states(jcfg(cfg), 2, 16)[i], cpu_states(cfg, 2, 16)[i]
        if cfg.layer_type(i) == "linear":
            want, (ws, wc) = jm.deltanet_forward(pj["deltanet"], jnp.asarray(x), jcfg(cfg), js,
                                                 jnp.asarray(valid))
            got, (gs, gc) = pm.deltanet_forward(pp["deltanet"], torch.from_numpy(x), cfg, ps,
                                                torch.from_numpy(valid))
            assert rel(gs.numpy(), ws) < TOL and rel(gc.numpy(), wc) < TOL
        else:
            want, jst = jm.gated_attention_forward(pj["attn"], jnp.asarray(x), jcfg(cfg), js,
                                                   jnp.asarray(pos), jnp.asarray(valid))
            got, pst = pm.gated_attention_forward(pp["attn"], torch.from_numpy(x), cfg, ps,
                                                  torch.from_numpy(pos), torch.from_numpy(valid))
            assert rel(pst[0].numpy(), jst[0]) < TOL and pst[3] == int(jst[3]) == 7
            np.testing.assert_array_equal(pst[2].numpy(), np.asarray(jst[2]))
        assert rel(got.numpy(), want) < TOL, (i, rel(got.numpy(), want))
    want, _ = jm.chat_forward(ref.params, jcfg(cfg), jnp.asarray(ids),
                              jm.init_states(jcfg(cfg), 2, 16), jnp.asarray(pos),
                              jnp.asarray(valid))
    got, _ = pm.chat_forward(port.params, cfg, torch.from_numpy(ids), cpu_states(cfg, 2, 16),
                             torch.from_numpy(pos), torch.from_numpy(valid))
    assert got.dtype == torch.float32
    assert rel(got.numpy(), want) < TOL, rel(got.numpy(), want)


def test_prefill_decode_parity_and_left_pad(dense):
    """[t0..t4] at once equals a prefill of [t0..t2] and two decode steps;
    a left-padded prompt's last logits equal the unpadded prompt's."""
    port, _ = dense
    p, cfg = port.params, port.cfg
    ids = torch.tensor([[3, 5, 7, 11, 13]])
    full, _ = pm.chat_forward(p, cfg, ids, cpu_states(cfg, 1, 16), torch.arange(5)[None],
                              torch.ones((1, 5), dtype=torch.bool))
    states = cpu_states(cfg, 1, 16)
    l3, states = pm.chat_forward(p, cfg, ids[:, :3], states, torch.arange(3)[None],
                                 torch.ones((1, 3), dtype=torch.bool))
    assert rel(l3[0, 2].numpy(), full[0, 2].numpy()) < TOL
    for t in (3, 4):
        lt, states = pm.chat_forward(p, cfg, ids[:, t:t + 1], states, torch.tensor([[t]]),
                                     torch.ones((1, 1), dtype=torch.bool))
        assert rel(lt[0, 0].numpy(), full[0, t].numpy()) < TOL, t
    padded = torch.tensor([[9, 9, 3, 5, 7]])
    l_pad, _ = pm.chat_forward(p, cfg, padded, cpu_states(cfg, 1, 16),
                               torch.tensor([[0, 0, 0, 1, 2]]),
                               torch.tensor([[False, False, True, True, True]]))
    assert rel(l_pad[0, -1].numpy(), full[0, 2].numpy()) < TOL


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["dense", "packed"])
def test_greedy_tokens_match_reference(which, request):
    port, ref = request.getfixturevalue(which)
    want = ref.generate_ids(PROMPT, max_new=20)
    got = port.generate_ids(PROMPT, max_new=20)
    assert got == want
    assert port.last_loop["steps_run"] == 20
    for chunk in (1, 6, 20, 100):
        assert list(port.generate_ids_stream(PROMPT, max_new=20, chunk=chunk)) == want, chunk
    # a prompt past one 32-token bucket, through the stream too
    long = list(range(1, 40))
    want = ref.generate_ids(long, max_new=6)
    assert port.generate_ids(long, max_new=6) == want
    assert list(port.generate_ids_stream(long, max_new=6, chunk=4)) == want


def test_eos_stops_generation(dense):
    port, _ = dense
    toks = port.generate_ids(PROMPT, max_new=12)
    cfg = dataclasses.replace(port.cfg, eos_token_id=toks[4])
    model = Qwen3Chat(cfg, pm.init_chat_params(np.random.default_rng(0), cfg), device="cpu")
    assert model.generate_ids(PROMPT, max_new=40) == toks[:4]
    # the first token comes from the prefill; the chunk in which EOS came
    # (steps 1-16) ran to its end
    assert model.last_loop["steps_run"] == 17
    assert list(model.generate_ids_stream(PROMPT, max_new=40, chunk=3)) == toks[:4]


def generation_logits(forward, init_states, arr, params, cfg, tokens, max_new=16):
    """The logits a greedy ``generate_ids`` of PROMPT sees at each step, with
    ``tokens`` forced: the prompt left-padded into its 32-token bucket, then
    one step a token into a cache of bucket + ``max_new`` slots, as both
    packages generate. → float64 [len(tokens), vocab]."""
    n, tb = len(PROMPT), 32
    ids = np.zeros((1, tb), np.int64)
    ids[0, tb - n:] = PROMPT
    valid = np.arange(tb)[None] >= tb - n
    pos = np.maximum(np.arange(tb)[None] - (tb - n), 0)
    logits, states = forward(params, cfg, arr(ids), init_states(cfg, 1, tb + max_new), arr(pos),
                             arr(valid))
    out = [np.asarray(logits[0, -1], np.float64)]
    for i, t in enumerate(tokens[:-1]):
        logits, states = forward(params, cfg, arr(np.array([[t]])), states,
                                 arr(np.array([[n + i]])), arr(np.ones((1, 1), bool)))
        out.append(np.asarray(logits[0, -1], np.float64))
    return np.stack(out)


def rel_l2(got, want):
    return np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)


#: bf16 activations at hidden 128 (the packed table's rows come back in
#: bf16): the reference's own logits lie 0.142 relative L2 from an fp32
#: evaluation of the same packed weights over the steps below, the port's
#: 0.065 and the port's from the reference's 0.082 (largest of the steps up
#: to and at the first parting), so two bf16 evaluations agree no closer
PACKED_TABLE_TOL = 0.1
#: the largest logit difference at the parting, of max |reference logit|
#: (reading 0.105)
PACKED_TABLE_GAP_TOL = 0.15


def test_packed_table_tokens_match_reference_up_to_a_near_tie():
    """The reference's ``quantize_tree`` also packs the embedding table:
    its rows come back in bf16, so the activations are bf16 and the two
    packages round differently. Each package's logits are taken along the
    reference's tokens as its generation computes them (their argmaxes are
    that generation's tokens). The tokens must be the reference's until the
    first parting; at every step up to and at it, the port's logits within
    ``PACKED_TABLE_TOL`` relative L2 of the reference's and no farther than
    the reference's from an fp32 evaluation; at the parting the largest
    logit difference (the gap) within ``PACKED_TABLE_GAP_TOL`` of max |ref|
    and the reference's margin between its token and the port's within
    twice the gap."""
    port, ref = pair(WIDE, quant_bits=4)
    assert "codes" in port.params["embed_tokens"] and "codes" in ref.params["embed_tokens"]
    want = ref.generate_ids(PROMPT, max_new=16)
    got = port.generate_ids(PROMPT, max_new=16)
    assert len(want) == len(got) == 16
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), len(want))
    steps = min(n + 1, len(want))
    jforward = jax.jit(jm.chat_forward, static_argnums=1)
    lj = generation_logits(jforward, jm.init_states, jnp.asarray, ref.params, jcfg(WIDE), want)
    with torch.inference_mode():
        lp = generation_logits(pm.chat_forward, cpu_states, torch.from_numpy, port.params,
                               WIDE, want)
    exact = dict(ref.params, embed_tokens=jquant.dequantize(ref.params["embed_tokens"],
                                                            WIDE.hidden_size))
    lt = generation_logits(jforward, jm.init_states, jnp.asarray, exact, jcfg(WIDE), want)
    np.testing.assert_array_equal(lj.argmax(-1), want)
    np.testing.assert_array_equal(lp.argmax(-1)[:steps], got[:steps])
    near = rel_l2(lp, lj)[:steps]
    port_err, ref_err = rel_l2(lp, lt)[:steps].max(), rel_l2(lj, lt)[:steps].max()
    print(f"packed table: first parting at step {n}; port vs reference {near.max():.4g} "
          f"(tol {PACKED_TABLE_TOL}); vs fp32: port {port_err:.4g}, reference {ref_err:.4g}")
    assert near.max() <= PACKED_TABLE_TOL, near
    assert port_err <= ref_err, (port_err, ref_err)
    if n < len(want):
        gap = np.abs(lj[n] - lp[n]).max()
        margin = lj[n, want[n]] - lj[n, got[n]]
        print(f"packed table: margin {margin:.4g}, gap {gap:.4g} "
              f"({gap / np.abs(lj[n]).max():.4g} of max |ref|, tol {PACKED_TABLE_GAP_TOL})")
        assert gap <= PACKED_TABLE_GAP_TOL * np.abs(lj[n]).max(), (n, gap)
        assert margin <= 2 * gap, (n, margin, gap)


def test_chat_sample_greedy_and_penalty_match():
    rng = np.random.default_rng(5)
    lg = rng.standard_normal((3, 40)).astype(np.float32)
    hist = rng.integers(-1, 45, (3, 8))  # negatives and ids ≥ V are empty slots
    for scfg in (ChatSamplingConfig(temperature=0.0, repetition_penalty=1.0),
                 ChatSamplingConfig(temperature=0.0, repetition_penalty=4.0),
                 ChatSamplingConfig(temperature=0.0, repetition_penalty=1.1)):
        jscfg = jm.ChatSamplingConfig(**dataclasses.asdict(scfg))
        want = np.asarray(jax_chat_sample(jnp.asarray(lg), jax.random.PRNGKey(0), jscfg,
                                          jnp.asarray(hist, jnp.int32)))
        got = chat_sample(torch.from_numpy(lg), None, scfg, torch.from_numpy(hist))
        np.testing.assert_array_equal(got.numpy(), want)
    pen = ChatSamplingConfig(temperature=0.0, repetition_penalty=4.0)
    one = torch.tensor([[0.5, 1.0, -2.0]])
    assert int(chat_sample(one, None, pen, torch.tensor([[1]]))[0]) == 0
    assert int(chat_sample(one, None, pen, torch.tensor([[-1]]))[0]) == 1


def test_chat_sample_distribution():
    """Temperature, top-k and top-p: the frequencies of 40,000 draws from
    one row match the filtered softmax the reference samples (|Δp| < 0.01
    everywhere), and filtered tokens never come."""
    lg = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -1.0, -3.0, 1.2]])
    scfg = ChatSamplingConfig(temperature=0.7, top_k=5, top_p=0.9, repetition_penalty=1.0)
    n = 40000
    gen = torch.Generator().manual_seed(0)
    draws = chat_sample(lg.expand(n, -1), gen, scfg, torch.full((n, 1), -1))
    freq = np.bincount(draws.numpy(), minlength=8) / n
    scaled = lg[0].numpy() / 0.7
    keep = scaled >= np.sort(scaled)[-5]
    p = np.where(keep, np.exp(scaled - scaled.max()), 0.0)
    p /= p.sum()
    order = np.argsort(-p)
    cum = np.cumsum(p[order])
    nucleus = order[: int(((cum - p[order]) < 0.9).sum())]  # the crossing token kept
    want = np.zeros(8)
    want[nucleus] = p[nucleus] / p[nucleus].sum()
    assert np.abs(freq - want).max() < 0.01, (freq, want)
    assert (freq[want == 0] == 0).all()


def test_sampled_generation_seeded():
    port, _ = pair(TINY)
    s = ChatSamplingConfig()
    a = port.generate_ids(PROMPT, max_new=10, seed=1, sampling=s)
    assert a == port.generate_ids(PROMPT, max_new=10, seed=1, sampling=s)
    assert list(port.generate_ids_stream(PROMPT, max_new=10, seed=1, sampling=s, chunk=3)) == a
    assert all(0 <= t < TINY.vocab_size for t in a)
    for preset in ("creative", "precise"):
        assert (dataclasses.asdict(getattr(ChatSamplingConfig, preset)())
                == dataclasses.asdict(getattr(jm.ChatSamplingConfig, preset)()))


def test_chat_template_and_chat(dense):
    msgs = [{"role": "system", "content": "S"}, {"role": "user", "content": "U"}]
    assert Qwen3Chat.apply_chat_template(msgs) == JaxChat.apply_chat_template(msgs)
    port, ref = dense
    port.tokenizer = chat_tokenizer()
    ref.tokenizer = chat_tokenizer()
    try:
        port.max_new = 12
        got = "".join(port.chat([{"role": "user", "content": "hi"}]))
        ids = port.tokenizer.encode(Qwen3Chat.apply_chat_template([{"role": "user",
                                                                     "content": "hi"}]))
        toks = [t for t in ref.generate_ids(ids, max_new=12)]
        assert got == port.tokenizer.decode(toks)
    finally:
        port.tokenizer = ref.tokenizer = None
        port.max_new = 128
    with pytest.raises(RuntimeError):
        next(port.chat([{"role": "user", "content": "hi"}]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def checkpoint_flat(params, cfg):
    """The HF/MLX layout ``convert_chat_checkpoint`` reads, from a tree in
    the reference's layout: packed linears as MLX ``weight``/``scales``/
    ``biases``, dense ones and tables as ``weight`` [out, in]."""
    flat = {}

    def lin(name, p):
        if "codes" in p:
            flat[f"{name}.weight"] = np.asarray(p["codes"]).astype(np.uint32)
            flat[f"{name}.scales"] = np.asarray(p["scales"], np.float32)
            flat[f"{name}.biases"] = np.asarray(p["biases"], np.float32)
        else:
            flat[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)

    flat["model.embed_tokens.weight"] = np.asarray(params["embed_tokens"], np.float32)
    flat["model.norm.weight"] = params["norm"]["weight"]
    for i, layer in enumerate(params["layers"]):
        pre = f"model.layers.{i}"
        flat[f"{pre}.input_layernorm.weight"] = layer["input_layernorm"]["weight"]
        flat[f"{pre}.post_attention_layernorm.weight"] = layer["post_attention_layernorm"]["weight"]
        for k, v in layer["mlp"].items():
            lin(f"{pre}.mlp.{k}", v)
        if "deltanet" in layer:
            d = layer["deltanet"]
            for k in ("in_proj_qkv", "in_proj_z", "in_proj_b", "in_proj_a", "out_proj"):
                lin(f"{pre}.linear_attn.{k}", d[k])
            flat[f"{pre}.linear_attn.conv1d.weight"] = np.asarray(d["conv_weight"])[:, None, :]
            flat[f"{pre}.linear_attn.dt_bias"] = d["dt_bias"]
            flat[f"{pre}.linear_attn.A_log"] = d["A_log"]
            flat[f"{pre}.linear_attn.norm.weight"] = d["norm"]["weight"]
        else:
            a = layer["attn"]
            for k in ("q_proj", "k_proj", "v_proj", "o_proj"):
                lin(f"{pre}.self_attn.{k}", a[k])
            flat[f"{pre}.self_attn.q_norm.weight"] = a["q_norm"]["weight"]
            flat[f"{pre}.self_attn.k_norm.weight"] = a["k_norm"]["weight"]
    return {k: np.ascontiguousarray(v) for k, v in flat.items()}


def test_converter_and_from_pretrained(tmp_path, monkeypatch):
    from safetensors.numpy import save_file

    params = quantize_tree_np(pm.init_chat_params(np.random.default_rng(3), WIDE), 4,
                              embed_keys=())
    save_file(checkpoint_flat(params, WIDE), str(tmp_path / "model.safetensors"))
    tok = chat_tokenizer()
    (tmp_path / "vocab.json").write_text(json.dumps(tok.vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"added_tokens_decoder": {
        str(i): {"content": t} for t, i in tok.special_tokens.items()}}))
    from qwen3_asr_swift_tpu_torch.core.weights import load_safetensors

    flat = load_safetensors(tmp_path)
    got = pconvert.convert_chat_checkpoint(flat, WIDE)
    want = jconvert.convert_chat_checkpoint(flat, jcfg(WIDE))
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert "codes" in got["layers"][0]["mlp"]["gate_proj"]

    monkeypatch.setattr(jm, "CONFIG_08B", jcfg(WIDE))
    ref = JaxChat.from_pretrained(str(tmp_path), dtype=jnp.float32)
    port = Qwen3Chat.from_pretrained(str(tmp_path), cfg=WIDE, dtype=torch.float32, device="cpu")
    assert port.tokenizer.encode("<|im_start|>hi") == ref.tokenizer.encode("<|im_start|>hi")
    assert port.generate_ids(PROMPT, max_new=10) == ref.generate_ids(PROMPT, max_new=10)
    with pytest.raises(FileNotFoundError):
        Qwen3Chat.from_pretrained(str(tmp_path / "missing"), cfg=WIDE, device="cpu",
                                  cache_dir=str(tmp_path / "cache"), offline_mode=True)
