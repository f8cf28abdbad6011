"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip (inside the test, via the ``card`` fixture)
where torch sees no CUDA device. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: 1e-5 relative to max |plain| for K1 and K3 (both fp32; they
differ from the plain versions in summation order and fused multiply-adds
(K3 also in its split-and-merge softmax),
~1e-7 measured at full width; K1's products of codes and x, fp32 x as
three bf16 terms, are exact on the tensor cores) and for K2 (its bf16 roundings are the plain
version's, bit for bit; only the fp32 sum order differs, against the plain
version's float64 sums); 2e-2 relative L2 for the tiny decoder's
logits, whose activations are bf16 (packed embedding), so a bf16 rounding
may land the other way between the card and the host.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu_torch.core import trace
from qwen3_asr_swift_tpu_torch.core.params import init_random_params
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import model as asr_model
from qwen3_asr_swift_tpu_torch.models.qwen3_asr.config import CONFIG_LARGE, CONFIG_SMALL
from qwen3_asr_swift_tpu_torch.models.qwen3_asr.decoder import decode_step
from qwen3_asr_swift_tpu_torch.ops import attention_int8 as k3
from qwen3_asr_swift_tpu_torch.ops import quant as k1
from qwen3_asr_swift_tpu_torch.ops.kv_cache import quantize_kv
from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def packed(out_dim, in_dim, bits, dev, seed=0, gs=64):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"codes": torch.randint(-2**31, 2**31 - 1, (out_dim, in_dim * bits // 32),
                                   generator=g, device=dev, dtype=torch.int32),
            "scales": torch.rand((out_dim, in_dim // gs), generator=g, device=dev) * 0.02,
            "biases": (torch.rand((out_dim, in_dim // gs), generator=g, device=dev) - 0.5) * 0.2}


@pytest.mark.parametrize("rows,in_dim,out_dim,bits", [
    (1, 1024, 4096, 4), (9, 192, 12, 4), (32, 3072, 1024, 4), (33, 2048, 100, 2),
    (256, 1024, 300, 8), (5, 128, 31, 2)])
def test_k1_matches_plain(card, rows, in_dim, out_dim, bits):
    p = packed(out_dim, in_dim, bits, card, seed=rows)
    x = torch.randn((rows, in_dim), device=card)
    before = k1.K1_LAUNCHES.value
    got = k1.quant_matmul_cuda(x, p)
    torch.cuda.synchronize()
    assert k1.K1_LAUNCHES.value == before + 1
    assert got.shape == (rows, out_dim) and got.dtype == torch.float32
    assert rel(got, k1.quant_matmul(x, p)) <= TOL


def test_k1_leading_dims_and_bf16_input(card):
    p = packed(64, 256, 4, card)
    x = torch.randn((2, 3, 256), device=card).to(torch.bfloat16)
    got = k1.quant_matmul_cuda(x, p)
    assert got.shape == (2, 3, 64)
    assert rel(got, k1.quant_matmul(x, p)) <= TOL


def test_k1_rejects_bad_inputs(card):
    p = packed(64, 256, 4, card)
    x = torch.randn((2, 256), device=card)
    with pytest.raises(TypeError):
        k1.quant_matmul_cuda(x, dict(p, scales=p["scales"].half()))
    with pytest.raises(ValueError):
        k1.quant_matmul_cuda(x, dict(p, codes=p["codes"].cpu()))
    with pytest.raises(ValueError):
        k1.quant_matmul_cuda(x, dict(p, scales=p["scales"].t().contiguous().t()))


@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows", [1, 8, 16, 32, 33, 256])
@pytest.mark.parametrize("in_dim,out_dim", [
    (1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 151936)])
def test_k1_decode_shapes_bf16_and_fp32_x(card, xdt, rows, in_dim, out_dim):
    """The decoder's products (qkv, o and down with K split over blocks,
    gate_up, the LM head) at the rows the slice, beam search and larger
    batches give K1, with the activations in either dtype the wrapper takes
    as they are."""
    p = packed(out_dim, in_dim, 4, card, seed=rows)
    x = torch.randn((rows, in_dim), device=card).to(getattr(torch, xdt))
    before = k1.K1_LAUNCHES.value
    got = k1.quant_matmul_cuda(x, p)
    torch.cuda.synchronize()
    assert k1.K1_LAUNCHES.value == before + 1
    assert got.shape == (rows, out_dim) and got.dtype == torch.float32
    assert rel(got, k1.quant_matmul(x, p)) <= TOL


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_k1_every_packing(card, bits, gs):
    """Every MLX packing K1 takes, 2-bit group 32 (an 8-byte group) among
    them, with and without the K split, in both activation dtypes."""
    for in_dim, out_dim in ((1024, 4096), (3072, 1024)):
        p = packed(out_dim, in_dim, bits, card, seed=bits + gs, gs=gs)
        for xdt in (torch.bfloat16, torch.float32):
            x = torch.randn((33, in_dim), device=card).to(xdt)
            assert rel(k1.quant_matmul_cuda(x, p), k1.quant_matmul(x, p)) <= TOL


def test_k1_rows_do_not_depend_on_the_batch(card):
    """An output row is bit-identical whether 1, 7, 33, 40 or 256 rows
    share the call, for one, two and four m-tiles per block, with and
    without the K split, in both activation dtypes."""
    for out_dim, in_dim in ((300, 1024), (9000, 1024), (1024, 3072)):
        p = packed(out_dim, in_dim, 4, card, seed=3)
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((256, in_dim), device=card).to(xdt)
            full = k1.quant_matmul_cuda(x, p)
            for n in (1, 7, 33, 40):
                assert torch.equal(k1.quant_matmul_cuda(x[:n], p), full[:n])
                assert torch.equal(k1.quant_matmul_cuda(x[256 - n:], p), full[256 - n:])


#: K1's products on the Qwen3-TTS frame loop at the 1.7B config: the
#: talker's qkv, o (and the text projection), gate_up, down and codec head,
#: and the code predictor's input projection, qkv, o, gate_up and down
TTS_SHAPES = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048), (2048, 3072),
              (2048, 1024), (1024, 4096), (1024, 6144), (3072, 1024)]


@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("in_dim,out_dim", TTS_SHAPES)
def test_k1_tts_shapes(card, xdt, rows, in_dim, out_dim):
    """The TTS frame loop's products at a solo synthesis's row (1) and a
    full pool's (8)."""
    p = packed(out_dim, in_dim, 4, card, seed=rows + in_dim)
    x = torch.randn((rows, in_dim), device=card).to(getattr(torch, xdt))
    before = k1.K1_LAUNCHES.value
    got = k1.quant_matmul_cuda(x, p)
    torch.cuda.synchronize()
    assert k1.K1_LAUNCHES.value == before + 1
    assert got.shape == (rows, out_dim) and got.dtype == torch.float32
    assert rel(got, k1.quant_matmul(x, p)) <= TOL


@pytest.mark.parametrize("in_dim,out_dim", TTS_SHAPES)
def test_k1_tts_rows_do_not_depend_on_the_batch(card, in_dim, out_dim):
    """A pooled row equals the same row computed alone, bit for bit (the
    pool's greedy codes are the solo path's)."""
    p = packed(out_dim, in_dim, 4, card, seed=5)
    for xdt in (torch.bfloat16, torch.float32):
        x = torch.randn((8, in_dim), device=card).to(xdt)
        full = k1.quant_matmul_cuda(x, p)
        for i in range(8):
            assert torch.equal(k1.quant_matmul_cuda(x[i:i + 1], p), full[i:i + 1])


#: K1's products on the PersonaPlex 7B frame loop: qkv, o, gate_up, down
#: (in 11264: the K split over shared memory) and the text head (out 32001:
#: odd, a ragged last tile)
PERSONAPLEX_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096), (4096, 32001)]


@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("in_dim,out_dim", PERSONAPLEX_SHAPES)
def test_k1_personaplex_shapes(card, xdt, rows, in_dim, out_dim):
    p = packed(out_dim, in_dim, 4, card, seed=rows + in_dim)
    x = torch.randn((rows, in_dim), device=card).to(getattr(torch, xdt))
    before = k1.K1_LAUNCHES.value
    got = k1.quant_matmul_cuda(x, p)
    torch.cuda.synchronize()
    assert k1.K1_LAUNCHES.value == before + 1
    assert got.shape == (rows, out_dim) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert rel(got, k1.quant_matmul(x, p)) <= TOL


@pytest.mark.parametrize("in_dim,out_dim", PERSONAPLEX_SHAPES)
def test_k1_personaplex_rows_do_not_depend_on_the_batch(card, in_dim, out_dim):
    p = packed(out_dim, in_dim, 4, card, seed=7)
    for xdt in (torch.bfloat16, torch.float32):
        x = torch.randn((8, in_dim), device=card).to(xdt)
        full = k1.quant_matmul_cuda(x, p)
        for i in (0, 3, 7):
            assert torch.equal(k1.quant_matmul_cuda(x[i:i + 1], p), full[i:i + 1])


def test_tiny_personaplex_on_card_matches_host(card):
    """A packed tiny PersonaPlex (widths 128, so every temporal linear and
    the text head pack) in fp32: the first frame's text logits and the
    depformer's codebook logits card vs host within 2e-2 relative L2, K1 at
    every packed product of the prefill and the frame, and greedy codes
    run on the card."""
    from qwen3_asr_swift_tpu_torch.models.personaplex import PersonaPlex, PersonaSampling
    from qwen3_asr_swift_tpu_torch.models.personaplex import model as pp

    cfg = dataclasses.replace(pp.config_tiny(), d_model=128, num_heads=4, head_dim=32,
                              intermediate_size=128, text_vocab=128)
    rng = np.random.default_rng(0)
    params = pp.init_personaplex_params(rng, cfg)
    mimi = pp.init_mimi_params(rng, cfg.mimi)
    audio = (0.2 * rng.standard_normal(3 * cfg.mimi.samples_per_frame)).astype(np.float32)
    got = {}
    for where in ("cpu", "cuda"):
        m = PersonaPlex(cfg, params, mimi, device=where, dtype=torch.float32, quant_bits=4)
        with torch.inference_mode():
            uc, nf, ve, nv, reads, n_prompt = m._conversation_inputs(audio, 24000, None, None)
            before = k1.K1_LAUNCHES.value
            cache = m._prefill(uc, ve, nv, reads, n_prompt, 4)
            sine = torch.tensor(pp.SINE_TOKENS[:8], device=m.device)[None]
            silence = torch.tensor(pp.SILENCE_TOKENS[:8], device=m.device)[None]
            hidden, text_logits = m._frame_hidden(
                cache, torch.tensor([cfg.text_pad], device=m.device), sine, silence)
            launches = k1.K1_LAUNCHES.value - before
            dep = pp.depformer_forward_logits(m.params, cfg, hidden,
                                              text_logits.argmax(-1), uc[:, :, 0])
        got[where] = (text_logits.cpu(), dep.cpu())
        if where == "cuda":
            assert launches == 2 * 4 + 2 * 4 + 1   # prefill's and the frame's products, the head
            out = m.respond(audio, 24000, sampling=PersonaSampling(audio_temperature=0.0,
                                                                   text_temperature=0.0,
                                                                   max_steps=4))
            assert np.isfinite(out.samples).all() and len(out.samples) > 0
    for c, h in zip(got["cuda"], got["cpu"]):
        assert (torch.linalg.vector_norm(c - h) / torch.linalg.vector_norm(h)).item() <= 2e-2


def test_k1_rejects_bad_dtype_group_and_device(card):
    p = packed(64, 256, 4, card)
    x = torch.randn((2, 256), device=card)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bf16 or fp32"):
            k1.quant_matmul_cuda(x.to(dt), p)
    for gs in (16, 256):   # packings outside the published group sizes
        with pytest.raises(ValueError, match="group sizes"):
            k1.quant_matmul_cuda(torch.randn((2, 512), device=card),
                                 packed(64, 512, 4, card, gs=gs))
    with pytest.raises(ValueError, match="on cuda"):
        k1.quant_matmul_cuda(x, {k: v.cpu() for k, v in p.items()})


@pytest.mark.parametrize("rows,in_dim,out_dim,bits", [
    (16, 1024, 4096, 4), (16, 2048, 1024, 4), (16, 1024, 6144, 4), (16, 3072, 1024, 4),
    (32, 1024, 4096, 4), (1, 1024, 4096, 4), (256, 1024, 4096, 4), (32, 1024, 4096, 2),
    (32, 1024, 4096, 8), (33, 2048, 100, 2), (5, 128, 31, 8), (9, 64, 12, 4),
    (70, 1024, 9000, 4), (256, 1024, 151936, 4)])
def test_k2_matches_plain(card, rows, in_dim, out_dim, bits):
    p = packed(out_dim, in_dim, bits, card, seed=rows)
    x = torch.randn((rows, in_dim), device=card)
    before = k1.K2_LAUNCHES.value
    got = k1.quant_matmul_plane_cuda(x, p)
    torch.cuda.synchronize()
    assert k1.K2_LAUNCHES.value == before + 1
    assert got.shape == (rows, out_dim) and got.dtype == torch.float32
    assert rel(got, k1.quant_matmul_plane(x, p)) <= TOL


@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows", [1, 8, 32, 33, 256])
@pytest.mark.parametrize("in_dim,out_dim,bits", [
    (1024, 4096, 4), (2048, 1024, 4), (3072, 1024, 2), (1024, 6144, 8)])
def test_k2_decode_shapes_bf16_and_fp32_x(card, xdt, rows, in_dim, out_dim, bits):
    """The decoder's products (qkv, o, down with K split over blocks,
    gate_up) at the rows the slice, the pool and beam search give K2, with
    the activations in either dtype the wrapper takes as they are."""
    p = packed(out_dim, in_dim, bits, card, seed=rows + bits)
    x = torch.randn((rows, in_dim), device=card).to(getattr(torch, xdt))
    got = k1.quant_matmul_plane_cuda(x, p)
    torch.cuda.synchronize()
    assert got.shape == (rows, out_dim) and got.dtype == torch.float32
    assert rel(got, k1.quant_matmul_plane(x, p)) <= TOL


def test_k2_rows_do_not_depend_on_the_batch(card):
    """An output row is bit-identical whether 1, 7, 33, 40 or 256 rows
    share the call, for one and two m-tiles per block, with and without the
    K split, in both activation dtypes."""
    for out_dim, in_dim in ((300, 1024), (9000, 1024), (1024, 3072)):
        p = packed(out_dim, in_dim, 4, card, seed=3)
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((256, in_dim), device=card).to(xdt)
            full = k1.quant_matmul_plane_cuda(x, p)
            for n in (1, 7, 33, 40):
                assert torch.equal(k1.quant_matmul_plane_cuda(x[:n], p), full[:n])
                assert torch.equal(k1.quant_matmul_plane_cuda(x[256 - n:], p), full[256 - n:])


def test_k2_lm_head_and_bf16_input(card):
    p = packed(151936, 1024, 4, card, seed=4)
    x = torch.randn((2, 8, 1024), device=card).to(torch.bfloat16)
    got = k1.quant_matmul_plane_cuda(x, p)
    assert got.shape == (2, 8, 151936)
    assert rel(got, k1.quant_matmul_plane(x, p)) <= TOL


def test_k2_rejects_bad_inputs(card):
    p = packed(64, 256, 4, card)
    x = torch.randn((2, 256), device=card)
    with pytest.raises(TypeError):
        k1.quant_matmul_plane_cuda(x, dict(p, scales=p["scales"].half()))
    with pytest.raises(ValueError):
        k1.quant_matmul_plane_cuda(x, dict(p, codes=p["codes"].cpu()))
    with pytest.raises(ValueError):
        k1.quant_matmul_plane_cuda(x, dict(p, biases=p["biases"].t().contiguous().t()))
    q = {"codes": torch.zeros((64, 6), dtype=torch.int32, device=card),  # in 48, group 16
         "scales": torch.ones((64, 3), device=card), "biases": torch.zeros((64, 3), device=card)}
    with pytest.raises(ValueError, match="multiple of 32|% 32"):
        k1.quant_matmul_plane_cuda(torch.randn((2, 48), device=card), q)
    q = {"codes": torch.zeros((64, 4), dtype=torch.int32, device=card),   # in 64, 2-bit, group 32
         "scales": torch.ones((64, 2), device=card), "biases": torch.zeros((64, 2), device=card)}
    with pytest.raises(ValueError, match="multiple of 128"):
        k1.quant_matmul_plane_cuda(torch.randn((2, 64), device=card), q)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bf16 or fp32"):
            k1.quant_matmul_plane_cuda(x.to(dt), p)


# row-parallel shards: (in, out) of the 0.6B's o_proj and down and the 7B's
# o_proj and down
ROW_PARALLEL = [(2048, 1024), (3072, 1024), (4096, 4096), (11264, 4096)]


@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows", [1, 32])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("in_dim,out_dim", ROW_PARALLEL)
def test_k1_row_parallel_shards_sum_to_the_whole_product(card, xdt, rows, tp, in_dim, out_dim):
    """K1 on each tp rank's row-parallel shard (the packed triple cut on
    group boundaries by ``shard_pytree``, contiguous), the partials summed
    over the ranks as the tp sum does (fp32), against the plain product on
    the whole weight."""
    from qwen3_asr_swift_tpu_torch.parallel import QWEN3_DECODER_RULES, Mesh, shard_pytree

    p = packed(out_dim, in_dim, 4, card, seed=tp)
    g = torch.Generator(device=card).manual_seed(rows)
    x = torch.randn((rows, in_dim), generator=g, device=card).to(getattr(torch, xdt))
    whole = k1.quant_matmul(x, p)
    n = in_dim // tp
    total = torch.zeros_like(whole)
    for r in range(tp):
        shard = shard_pytree({"o_proj": p}, Mesh(dp=1, tp=tp, rank=r),
                             QWEN3_DECODER_RULES)["o_proj"]
        assert shard["codes"].shape == (out_dim, n * 4 // 32)
        assert all(t.is_contiguous() for t in shard.values())
        before = k1.K1_LAUNCHES.value
        total += k1.quant_matmul_cuda(x[:, r * n:(r + 1) * n], shard)
        torch.cuda.synchronize()
        assert k1.K1_LAUNCHES.value == before + 1
    assert rel(total, whole) <= TOL


def k3_inputs(dev, b, hq, hkv, length, d, seed=None):
    g = torch.Generator(device=dev).manual_seed(length if seed is None else seed)
    q = torch.randn((b, hq, 1, d), generator=g, device=dev).to(torch.bfloat16)
    kq, ks = quantize_kv(torch.randn((b, hkv, length, d), generator=g, device=dev))
    vq, vs = quantize_kv(torch.randn((b, hkv, length, d), generator=g, device=dev))
    valid = torch.rand((b, length), generator=g, device=dev) > 0.3
    valid[:, 0] = True
    return q, kq, ks, vq, vs, valid


@pytest.mark.parametrize("b,hq,hkv,length,d", [
    (32, 16, 8, 580, 128), (2, 4, 2, 37, 32), (3, 8, 8, 130, 64), (1, 8, 1, 64, 128),
    (1, 2, 1, 3, 256),
    # short caches, and around the split boundaries at D 128 (192 keys a split)
    (2, 4, 2, 1, 128), (2, 4, 2, 63, 128), (2, 4, 2, 64, 128), (2, 4, 2, 65, 128),
    (2, 4, 2, 129, 128), (2, 4, 2, 192, 128), (2, 4, 2, 193, 128), (2, 4, 2, 385, 128),
    (16, 16, 8, 580, 128),          # beam's rows
    (8, 8, 4, 580, 128), (8, 4, 2, 580, 128),   # a tp rank's heads of the 0.6B at tp 2, 4
    (2, 16, 2, 300, 128),           # G 8 at D 128
    (1, 4, 1, 2000, 256)])          # G 4 at D 256, many splits
def test_k3_matches_plain(card, b, hq, hkv, length, d):
    q, kq, ks, vq, vs, valid = k3_inputs(card, b, hq, hkv, length, d)
    before = k3.K3_LAUNCHES.value
    got = k3.decode_attention_int8(q, kq, ks, vq, vs, valid)
    torch.cuda.synchronize()
    assert k3.K3_LAUNCHES.value == before + 1
    assert got.dtype == torch.float32
    assert rel(got, k3.decode_attention_int8_ref(q, kq, ks, vq, vs, valid)) <= TOL


def test_k3_rows_do_not_depend_on_the_batch_or_the_call(card):
    args = k3_inputs(card, 32, 16, 8, 580, 128)
    full = k3.decode_attention_int8(*args)
    again = k3.decode_attention_int8(*args)
    assert torch.equal(full, again)
    for i in (0, 13, 31):
        alone = k3.decode_attention_int8(*(t[i:i + 1].contiguous() for t in args))
        assert torch.equal(alone, full[i:i + 1])


def test_k3_bf16_query_equals_its_fp32_widening(card):
    q, *rest = k3_inputs(card, 4, 16, 8, 580, 128)
    assert q.dtype == torch.bfloat16
    assert torch.equal(k3.decode_attention_int8(q, *rest),
                       k3.decode_attention_int8(q.float(), *rest))


@pytest.mark.parametrize("length", [40, 580])
def test_k3_bf16_output_is_the_rounded_fp32_output(card, length):
    args = k3_inputs(card, 4, 16, 8, length, 128)
    got = k3.decode_attention_int8(*args, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, k3.decode_attention_int8(*args).to(torch.bfloat16))


@pytest.mark.parametrize("length", [40, 580])
def test_k3_fully_masked_row_is_the_uniform_average(card, length):
    q, kq, ks, vq, vs, valid = k3_inputs(card, 3, 16, 8, length, 128)
    valid[1] = False
    got = k3.decode_attention_int8(q, kq, ks, vq, vs, valid)
    ref = k3.decode_attention_int8_ref(q, kq, ks, vq, vs, valid)
    uniform = (vq[1].float() * vs[1][..., None]).mean(dim=1)        # [Hkv, D]
    assert torch.isfinite(got).all()
    assert rel(got, ref) <= TOL
    assert rel(got[1, :, 0], uniform.repeat_interleave(2, dim=0)) <= TOL


def test_k3_rejects_bad_inputs(card):
    q = torch.randn((1, 4, 1, 32), device=card)
    kq = torch.zeros((1, 2, 8, 32), dtype=torch.int8, device=card)
    s = torch.ones((1, 2, 8), device=card)
    valid = torch.ones((1, 8), dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        k3.decode_attention_int8(q, kq.float(), s, kq, s, valid)
    with pytest.raises(ValueError):
        k3.decode_attention_int8(q, kq, s, kq, s, valid.to(torch.uint8))
    with pytest.raises(TypeError, match="bf16 or fp32"):
        k3.decode_attention_int8(q.half(), kq, s, kq, s, valid)
    with pytest.raises(TypeError, match="out_dtype"):
        k3.decode_attention_int8(q, kq, s, kq, s, valid, out_dtype=torch.float16)


def test_tiny_decoder_on_card_matches_host_and_launches_kernels(card):
    cfg = config_tiny()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2,
        head_dim=32), encoder=dataclasses.replace(cfg.encoder, output_dim=128))
    enc, dec = init_random_params(cfg, 0, quant_bits=4)
    rng = np.random.default_rng(0)
    clips = [(0.1 * rng.standard_normal(16000)).astype(np.float32)] * 2
    logits, tok = {}, None
    for where in ("cpu", "cuda"):
        m = Qwen3ASR(cfg, enc, dec, device=where, dtype=torch.float32, kv_dtype=torch.int8,
                     audio_buckets_s=(8,))
        with torch.inference_mode():
            st = m.prestage(clips)
            audio, n_audio = m._encode(st)
            state = m._gen_start(audio, n_audio, m._prompt(2, None, None), 4,
                                 SamplingOptions(max_tokens=4))
            tok = state.tokens[:, 0].cpu() if tok is None else tok
            before = (k1.K1_LAUNCHES.value, k3.K3_LAUNCHES.value)
            out, _ = decode_step(m.decoder_params, cfg.decoder, tok.to(m.device), state.cache)
            after = (k1.K1_LAUNCHES.value, k3.K3_LAUNCHES.value)
        logits[where] = out.float().cpu()
        if where == "cuda":
            # 2 layers × 4 packed products + LM head; 2 layers of K3
            assert after[0] - before[0] == 9 and after[1] - before[1] == 2
        res = m.transcribe_batch(clips, max_tokens=5)
        assert all(r.text for r in res)
    rel_l2 = (torch.linalg.vector_norm(logits["cuda"] - logits["cpu"])
              / torch.linalg.vector_norm(logits["cpu"])).item()
    assert rel_l2 <= 2e-2


#: K1's products on the Qwen3.5 0.8B chat (hidden 1024): DeltaNet in_proj_qkv,
#: in_proj_z and out_proj; gated attention q (with its gate), k/v and o; the
#: MLP's gate/up and down; the tied LM head (out 151,936)
CHAT_SHAPES = [(1024, 6144), (1024, 2048), (2048, 1024), (1024, 4096), (1024, 512),
               (1024, 3072), (3072, 1024), (1024, 151936)]


@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows", [1, 32])
@pytest.mark.parametrize("in_dim,out_dim", CHAT_SHAPES)
def test_k1_chat_shapes(card, xdt, rows, in_dim, out_dim):
    p = packed(out_dim, in_dim, 4, card, seed=rows + out_dim)
    x = torch.randn((rows, in_dim), device=card).to(getattr(torch, xdt))
    before = k1.K1_LAUNCHES.value
    got = k1.quant_matmul_cuda(x, p)
    torch.cuda.synchronize()
    assert k1.K1_LAUNCHES.value == before + 1
    assert got.shape == (rows, out_dim) and torch.isfinite(got).all()
    assert rel(got, k1.quant_matmul(x, p)) <= TOL


def test_tiny_packed_chat_on_card_matches_host(card):
    """A packed tiny chat (hidden 128: every linear of the MLP and the
    attention, and the embedding table, pack) in fp32: the prompt's logits
    card vs host within 2e-2 relative L2 (the packed table's rows are bf16,
    so the activations are), K1 at every packed product, the stream's tokens
    the monolithic decode's."""
    from qwen3_asr_swift_tpu_torch.models.chat import Qwen3Chat
    from qwen3_asr_swift_tpu_torch.models.chat import model as chat

    cfg = dataclasses.replace(chat.config_tiny(), hidden_size=128, intermediate_size=256)
    params = chat.init_chat_params(np.random.default_rng(0), cfg)
    ids = torch.tensor([[3, 5, 7, 11, 13]])
    logits = {}
    for where in ("cpu", "cuda"):
        m = Qwen3Chat(cfg, params, device=where, quant_bits=4)
        with torch.inference_mode():
            before = k1.K1_LAUNCHES.value
            out, _ = chat.chat_forward(m.params, cfg, ids.to(m.device),
                                       chat.init_states(cfg, 1, 8, device=m.device),
                                       torch.arange(5, device=m.device)[None])
            launches = k1.K1_LAUNCHES.value - before
        logits[where] = out.cpu()
        if where == "cuda":
            assert launches == chat.packed_products(m.params)
            before = k1.K1_LAUNCHES.value
            toks = m.generate_ids([3, 5, 7], max_new=12)
            assert k1.K1_LAUNCHES.value - before == \
                m.last_loop["steps_run"] * chat.packed_products(m.params)
            assert list(m.generate_ids_stream([3, 5, 7], max_new=12, chunk=5)) == toks
    rel_l2 = (torch.linalg.vector_norm(logits["cuda"] - logits["cpu"])
              / torch.linalg.vector_norm(logits["cpu"])).item()
    assert rel_l2 <= 2e-2


def test_tiny_realtime_session_on_card_matches_host(card):
    """A packed tiny PersonaPlex session (widths 128, fp32, batch 2): the
    streaming Mimi codes of each frame, the agent codes and text tokens card
    vs host, K1 at 8 products of the prefill and 9 a frame, finite audio."""
    from qwen3_asr_swift_tpu_torch.models.personaplex import PersonaPlex, PersonaSampling
    from qwen3_asr_swift_tpu_torch.models.personaplex import model as pp

    cfg = dataclasses.replace(pp.config_tiny(), d_model=128, num_heads=4, head_dim=32,
                              intermediate_size=128, text_vocab=128)
    rng = np.random.default_rng(0)
    params = pp.init_personaplex_params(rng, cfg)
    mimi = pp.init_mimi_params(rng, cfg.mimi)
    spf = cfg.mimi.samples_per_frame
    frames = (0.2 * rng.standard_normal((4, 2, spf))).astype(np.float32)
    greedy = PersonaSampling(audio_temperature=0.0, text_temperature=0.0)
    got = {}
    for where in ("cpu", "cuda"):
        m = PersonaPlex(cfg, params, mimi, device=where, dtype=torch.float32, quant_bits=4)
        before = k1.K1_LAUNCHES.value
        s = m.realtime_session(greedy, batch=2)
        rows = []
        for f in frames:
            wav = s.push_frames(f)
            assert wav.shape == (2, spf) and np.isfinite(wav).all()
            rows.append((s.last_codes.cpu(), s._text.cpu(), s._user1.cpu()))
        if where == "cuda":
            assert k1.K1_LAUNCHES.value - before == 2 * 4 + 4 * (2 * 4 + 1)
        got[where] = rows
    for (cc, ct, cu), (hc, ht, hu) in zip(got["cuda"], got["cpu"]):
        assert torch.equal(cu, hu)
        assert torch.equal(cc, hc) and torch.equal(ct, ht)


def test_pipeline_adapter_on_a_foreign_thread_runs_on_the_models_card(card):
    """The engine calls the adapters from its own thread, which torch has
    not seen: each runs under the model's card, and K1 launches there."""
    from qwen3_asr_swift_tpu_torch.cli import chat_tokenizer
    from qwen3_asr_swift_tpu_torch.models.chat import Qwen3Chat
    from qwen3_asr_swift_tpu_torch.models.chat import model as chat
    from qwen3_asr_swift_tpu_torch.pipeline import VoicePipeline
    import threading

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    cfg = dataclasses.replace(chat.config_tiny(), hidden_size=128, intermediate_size=256)
    model = Qwen3Chat.init_random(cfg, quant_bits=4, tokenizer=chat_tokenizer(), device=last)
    model.max_new = 4
    seen = {}
    chat_fn = model.chat

    def spying_chat(messages, tools=()):
        seen["device"] = torch.cuda.current_device()
        yield from chat_fn(messages, tools)

    model.chat = spying_chat
    p = VoicePipeline(llm=model, tts=lambda t: np.zeros(16, np.int16))
    before = k1.K1_LAUNCHES.value
    out = {}
    t = threading.Thread(target=lambda: out.update(ptr=p._llm_cb(b"hello", None)))
    t.start()
    t.join(timeout=120)
    p.close()
    assert out.get("ptr") and seen["device"] == last.index
    assert k1.K1_LAUNCHES.value > before


@pytest.mark.parametrize("cin,h,w", [(1, 128, 100), (480, 64, 50), (480, 32, 25)])
def test_fp32_conv2d_is_full_precision_with_cudnn_defaults(card, cin, h, w):
    """fp32 ``conv2d_nchw`` at the encoder's three stride-2 shapes (16
    chunks of 1 s) within 1e-5 of max |host| with cuDNN's TF32 flag at its
    default (True): fp32 convs are tap matmuls, never cuDNN's TF32."""
    from qwen3_asr_swift_tpu_torch.ops.nn import conv2d_nchw

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True   # the default; the fixture turns it off
    try:
        g = torch.Generator().manual_seed(cin + h)
        x = torch.randn((16, cin, h, w), generator=g)
        p = {"kernel": torch.randn((3, 3, cin, 480), generator=g) / (9 * cin) ** 0.5,
             "bias": torch.randn((480,), generator=g) * 0.1}
        want = conv2d_nchw(x, p)
        got = conv2d_nchw(x.to(card), {k: v.to(card) for k, v in p.items()})
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel(got.cpu(), want) <= TOL


@pytest.mark.parametrize("shape,k,stride,padding", [
    ((1, 1601, 64, 256), 3, (2, 2), ((1, 1), (1, 1))),    # FastConformer's sub_dw2 (16 s)
    ((1, 801, 32, 256), 3, (2, 2), ((1, 1), (1, 1))),     # and sub_dw3
    ((1, 25, 19, 128), 7, (1, 1), ((0, 0), (3, 3)))])     # the Zipformer's ConvNeXt
def test_fp32_depthwise_conv2d_is_full_precision_with_cudnn_defaults(card, shape, k, stride,
                                                                      padding):
    """fp32 ``depthwise_conv2d`` at the FastConformer's and the Zipformer's
    published shapes within 1e-5 of max |host| with cuDNN's TF32 flag at its
    default (True): its fp32 path is a sum of tap products, never cuDNN."""
    from qwen3_asr_swift_tpu_torch.ops.nn import depthwise_conv2d

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True   # the default; the fixture turns it off
    try:
        g = torch.Generator().manual_seed(shape[1])
        x = torch.randn(shape, generator=g)
        p = {"kernel": torch.randn((k, k, 1, shape[-1]), generator=g) / k,
             "bias": torch.randn((shape[-1],), generator=g) * 0.1}
        want = depthwise_conv2d(x, p, stride=stride, padding=padding)
        got = depthwise_conv2d(x.to(card), {n: v.to(card) for n, v in p.items()}, stride=stride,
                               padding=padding)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel(got.cpu(), want) <= TOL


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_tree_on_the_card_is_the_numpy_packing(card, bits):
    """``quantize_tree`` on the card packs as ``quantize_tree_np`` does on
    the host, bit for bit (codes, scales, biases). PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, so ``(max - min) /
    levels`` took another rounding there and changed the codes of the
    trees packed on the card."""
    from qwen3_asr_swift_tpu_torch.core.params import params_from_jax, quantize_tree_np

    rng = np.random.default_rng(bits)
    tree = {"a": {"kernel": rng.standard_normal((1024, 3072), dtype=np.float32) * 0.05},
            "embed_tokens": rng.standard_normal((512, 1024), dtype=np.float32) * 0.02}
    want = quantize_tree_np(tree, bits)
    got = k1.quantize_tree(params_from_jax(tree, card, torch.float32), bits)
    for name in ("a", "embed_tokens"):
        np.testing.assert_array_equal(got[name]["codes"].cpu().numpy().view(np.uint32),
                                      want[name]["codes"])
        for k in ("scales", "biases"):
            np.testing.assert_array_equal(got[name][k].cpu().numpy(), want[name][k])


def test_int8_kv_and_group_dot_scales_on_the_card_are_the_hosts(card):
    """The int8 KV quantizer and the group-dot activation quantizer divide
    max|x| by 127 as a true division on the card, so the same fp32 input
    gives the host's scales and codes bit for bit."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 4, 33, 128), generator=g) * 3.0
    kq, ks = quantize_kv(x)
    ckq, cks = quantize_kv(x.to(card))
    assert torch.equal(cks.cpu(), ks) and torch.equal(ckq.cpu(), kq)
    p = k1.repack_groupdot(packed(64, 256, 4, "cpu", seed=6), 64)
    xs = torch.randn((3, 256), generator=g)
    want = k1.quant_matmul_groupdot(xs, p)
    got = k1.quant_matmul_groupdot(xs.to(card), {k: v.to(card) for k, v in p.items()})
    assert rel(got.cpu(), want) <= TOL


# -- the speaker and VAD families, separation, translation: card vs host ------------

def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _voices(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = np.where((t // 1.2).astype(int) % 2 == 0, 120.0, 230.0)
    wave = sum(np.sin(2 * np.pi * np.cumsum(f0) / 16000 * k) / k for k in range(1, 5))
    return (0.25 * wave * ((t % 1.2) < 0.9) + 0.01 * rng.standard_normal(n)).astype(np.float32)


def test_tiny_pyannote_and_firered_on_card_match_host(card):
    """Pyannote's batched windows and FireRed's one-pass and chunked paths on
    the card within 1e-4 of the host (fp32 both)."""
    import dataclasses

    from qwen3_asr_swift_tpu_torch.models.firered_vad import FireRedVAD
    from qwen3_asr_swift_tpu_torch.models.firered_vad import config_tiny as fr_tiny
    from qwen3_asr_swift_tpu_torch.models.pyannote import PyannoteSegmentation

    audio = _voices(16000 * 7)
    host = PyannoteSegmentation.init_random(seed=1, device="cpu")
    dev = PyannoteSegmentation(host.cfg, _tree_to(host.params, card), device=card)
    want = host.speaker_activity(audio)
    assert np.abs(dev.speaker_activity(audio) - want).max() <= 1e-4 * np.abs(want).max()
    for cfg in (fr_tiny(), dataclasses.replace(fr_tiny(), max_frames=100)):
        host = FireRedVAD.init_random(cfg, seed=2, device="cpu")
        dev = FireRedVAD(cfg, _tree_to(host.params, card), device=card)
        got, want = dev.frame_probabilities(audio), host.frame_probabilities(audio)
        assert dev.last_path == host.last_path and np.abs(got - want).max() <= 1e-4


def test_tiny_speaker_models_on_card_match_host(card):
    """WeSpeaker at narrow widths (a clip near its bucket's edge, a batch of
    three lengths) and CAM++ at ``config_tiny()``: card vs host within 1e-4
    relative L2; batch rows on the card within 1e-5 of ``embed``."""
    from qwen3_asr_swift_tpu_torch.models.speaker import CampPlusSpeaker, WeSpeaker
    from qwen3_asr_swift_tpu_torch.models.speaker.model import init_wespeaker_params

    tree = init_wespeaker_params(np.random.default_rng(3), embed_dim=16, channels=(8, 8, 16, 16))
    host, dev = WeSpeaker(tree, device="cpu"), WeSpeaker(tree, device=card)
    clips = [_voices(n, i) for i, n in enumerate((31500, 20000, 45000))]
    got, want = dev.embed(clips[0]), host.embed(clips[0])
    assert rel(torch.from_numpy(got), torch.from_numpy(want)) <= 1e-4
    batch = dev.embed_batch(clips)
    assert rel(torch.from_numpy(batch), torch.from_numpy(host.embed_batch(clips))) <= 1e-4
    same = dev.embed_batch(clips[:2])
    for i, c in enumerate(clips[:2]):
        assert rel(torch.from_numpy(same[i]), torch.from_numpy(dev.embed(c))) <= 1e-5
    host = CampPlusSpeaker.init_random(seed=4, device="cpu")
    dev = CampPlusSpeaker(host.cfg, _tree_to(host.params, card), device=card)
    for c in clips:
        assert rel(torch.from_numpy(dev.embed(c)), torch.from_numpy(host.embed(c))) <= 1e-4


def test_tiny_diarization_on_card_matches_host(card):
    """The pipeline over a VAD that hears speech everywhere and a narrow
    WeSpeaker on the card: segments and speakers equal the host's, with
    the threshold and with ``num_speakers``."""
    from qwen3_asr_swift_tpu_torch.core.types import SpeechSegment
    from qwen3_asr_swift_tpu_torch.models.diarization import DiarizationPipeline
    from qwen3_asr_swift_tpu_torch.models.speaker import WeSpeaker
    from qwen3_asr_swift_tpu_torch.models.speaker.model import init_wespeaker_params

    class Everywhere:
        def detect_speech(self, audio, sample_rate=16000):
            return [SpeechSegment(0.0, len(audio) / sample_rate)]

    tree = init_wespeaker_params(np.random.default_rng(7), embed_dim=16, channels=(8, 8, 16, 16))
    audio = _voices(16000 * 9, 3)
    for num in (None, 2):
        got, want = (DiarizationPipeline(Everywhere(), WeSpeaker(tree, device=dev)).diarize(
            audio, num_speakers=num) for dev in (card, "cpu"))
        assert [(s.start, s.end, s.speaker) for s in got] == \
            [(s.start, s.end, s.speaker) for s in want]


def test_tiny_separation_and_translation_on_card_match_host(card):
    """Open-Unmix at hidden 16 (all stems, one loop): each stem within 1e-4
    of max |host|; MADLAD at ``config_tiny()``: greedy ids equal and the
    step logits within 1e-4."""
    from qwen3_asr_swift_tpu_torch.models.separation import SourceSeparator
    from qwen3_asr_swift_tpu_torch.models.separation.model import STEMS, init_umx_params
    from qwen3_asr_swift_tpu_torch.models.translation import MADLADTranslator, config_tiny
    from qwen3_asr_swift_tpu_torch.models.translation import model as t5

    rng = np.random.default_rng(5)
    stems = {s: init_umx_params(rng, hidden=16) for s in STEMS}
    x = np.stack([_voices(44100, 1), _voices(44100, 2)])
    want = SourceSeparator(stems, device="cpu").separate(x, 44100)
    got = SourceSeparator(stems, device=card).separate(x, 44100)
    for s in STEMS:
        assert np.abs(got[s] - want[s]).max() <= 1e-4 * np.abs(want[s]).max(), s
    host = MADLADTranslator.init_random(config_tiny(), seed=6, device="cpu")
    dev = MADLADTranslator(host.cfg, _tree_to(host.params, card), device=card)
    ids = rng.integers(2, 128, 19).tolist()
    logits = {}
    for where, m in (("host", host), ("card", dev)):
        arr, valid = m.prepare(ids)
        seen = logits[where] = []
        t5.greedy_translate(m.params, m.cfg, arr, valid, 12, on_step=lambda s, lg: seen.append(
            lg.float().cpu()))
    for g, w in zip(logits["card"], logits["host"]):
        assert rel(g, w) <= 1e-4
    assert dev.translate_ids(ids, max_new=12) == host.translate_ids(ids, max_new=12)


def test_tiny_asr_engines_wake_word_and_sortformer_on_card_match_host(card):
    """The last families at their tiny configs (the Zipformer at its own
    3.19M), fp32, card vs host: the wake word's frames within 1e-4 and its
    session's frames within 1e-5 of its batch on the card; Parakeet TDT's
    and Omnilingual's tokens and streaming Parakeet's results equal;
    Sortformer's segments equal."""
    from qwen3_asr_swift_tpu_torch.models.diarization import SortformerDiarizer
    from qwen3_asr_swift_tpu_torch.models.omnilingual import OmnilingualASR
    from qwen3_asr_swift_tpu_torch.models.parakeet import ParakeetASR, config_tiny
    from qwen3_asr_swift_tpu_torch.models.parakeet_streaming import ParakeetStreamingASR
    from qwen3_asr_swift_tpu_torch.models.wakeword import (Keyword, WakeWordDetector,
                                                           WakeWordSession)

    audio = _voices(16000 * 3, 5)
    host = WakeWordDetector.init_random([Keyword("hi", [5, 6])], seed=1, device="cpu")
    dev = WakeWordDetector(_tree_to(host.params, "cpu"), host.keywords, device=card)
    want, got = host._batch_encoder_frames(audio), dev._batch_encoder_frames(audio)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    session = WakeWordSession(dev, collect_encoder=True)
    session.push(audio[:7000])
    session.push(audio[7000:])
    session.finalize()
    assert np.abs(np.concatenate(session.encoder_frames) - got).max() <= 1e-5 * np.abs(got).max()
    host = ParakeetASR.init_random(config_tiny(), seed=2, dtype=torch.float32, device="cpu")
    dev = ParakeetASR(host.cfg, _tree_to(host.encoder_params, "cpu"),
                      _tree_to(host.decoder_params, "cpu"), dtype=torch.float32, device=card)
    clips = [audio, audio[:20000]]
    assert [r.text for r in dev.transcribe_batch(clips)] == \
        [r.text for r in host.transcribe_batch(clips)]
    host = ParakeetStreamingASR.init_random(seed=3, device="cpu")
    dev = ParakeetStreamingASR(host.cfg, _tree_to(host.encoder_params, "cpu"),
                               _tree_to(host.decoder_params, "cpu"), device=card)
    assert dev.transcribe(audio).text == host.transcribe(audio).text
    host = OmnilingualASR.init_random(seed=4, device="cpu")
    dev = OmnilingualASR(host.cfg, _tree_to(host.params, "cpu"), dtype=torch.float32, device=card)
    assert dev.transcribe(audio).text == host.transcribe(audio).text
    host = SortformerDiarizer.init_random(seed=5, device="cpu")
    dev = SortformerDiarizer(host.cfg, _tree_to(host.params, "cpu"), device=card)
    assert [(s.start, s.end, s.speaker) for s in dev.diarize(audio)] == \
        [(s.start, s.end, s.speaker) for s in host.diarize(audio)]


# ---------------------------------------------------------------------------
# the Qwen3-ASR decode loop replayed from a CUDA graph (models/qwen3_asr/model.py)
# ---------------------------------------------------------------------------

#: K1, K3, then the graph path's captures, replays and eager steps
GRAPH_COUNTERS = (k1.K1_LAUNCHES, k3.K3_LAUNCHES, trace.GRAPH_CAPTURES, trace.GRAPH_REPLAYS,
                  trace.EAGER_STEPS)


def graph_model(card, base, layers, bits, kv):
    """``base``'s widths cut to ``layers`` encoder and decoder layers, drawn
    on the card and packed to ``bits``; q/k norm weights 2, so that tokens
    vary (at 1 a random model decodes one token whatever it hears)."""
    cfg = dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, num_layers=layers),
        decoder=dataclasses.replace(base.decoder, num_layers=layers, bits=bits, group_size=64))
    enc, dec = init_random_params(cfg, 0, quant_bits=bits, device=card)
    for layer in dec["layers"]:
        for name in ("q_norm", "k_norm"):
            layer[name]["weight"] = layer[name]["weight"] * 2
    return Qwen3ASR(cfg, enc, dec, device=card, dtype=torch.bfloat16, kv_dtype=kv,
                    audio_buckets_s=(8,), decode_chunk_tokens=15)


def graph_clips(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(int(16000 * (3 + 5 * i / n)))).astype(np.float32)
            for i in range(n)]


def decode_with_counts(m, clips, opts, monkeypatch, graph=True):
    """(tokens, logprobs, counter deltas, decode steps) of one batch, through
    the graph path or (``graph`` False) the eager loop."""
    if not graph:
        monkeypatch.setattr(asr_model, "uses_step_graph", lambda *a: False)
    before = [c.value for c in GRAPH_COUNTERS]
    gen = torch.Generator(device=m.device).manual_seed(0)
    tokens, logprobs = m._generate(m.prestage(clips), (None, None), opts, None, gen)
    torch.cuda.synchronize()
    monkeypatch.undo()
    return (tokens.cpu(), logprobs.cpu(), [c.value - b for c, b in zip(GRAPH_COUNTERS, before)],
            m.last_loop["decode_steps"])


@pytest.mark.parametrize("base,kv,bits", [(CONFIG_SMALL, torch.int8, 4),
                                          (CONFIG_LARGE, torch.bfloat16, 8)],
                         ids=["0.6b-int8-kv", "1.7b-bf16-kv"])
def test_decode_graph_replays_the_eager_loop_bit_for_bit(card, monkeypatch, base, kv, bits):
    layers = 3
    m = graph_model(card, base, layers, bits, kv)
    clips = graph_clips(8)
    opts = SamplingOptions(max_tokens=40)
    want_tok, want_lp, eager, steps = decode_with_counts(m, clips, opts, monkeypatch, False)
    got_tok, got_lp, graph, got_steps = decode_with_counts(m, clips, opts, monkeypatch)
    assert len(set(want_tok.flatten().tolist())) > 1
    assert torch.equal(got_tok, want_tok) and torch.equal(got_lp, want_lp)
    assert got_steps == steps == opts.max_tokens - 1
    # K1: the prefill's head, then 4 packed products a layer and the head a
    # step; K3 a layer a step (int8 cache only)
    k3_want = steps * layers if kv == torch.int8 else 0
    assert eager[:2] == graph[:2] == [1 + steps * (4 * layers + 1), k3_want]
    assert eager[2:] == [0, 0, steps]
    assert graph[2:] == [1, steps - 1, 1]


@pytest.mark.parametrize("opts", [dict(temperature=0.7), dict(repetition_penalty=1.1),
                                  dict(top_k=5, temperature=0.5)],
                         ids=["temperature", "penalty", "top-k"])
def test_sampled_decode_stays_eager(card, opts):
    cfg = dataclasses.replace(config_tiny(), decoder=dataclasses.replace(
        config_tiny().decoder, hidden_size=128, intermediate_size=256, num_heads=4,
        num_kv_heads=2, head_dim=32), encoder=dataclasses.replace(config_tiny().encoder,
                                                                  output_dim=128))
    enc, dec = init_random_params(cfg, 0, quant_bits=4)
    m = Qwen3ASR(cfg, enc, dec, device=card, kv_dtype=torch.int8, audio_buckets_s=(8,))
    before = [c.value for c in GRAPH_COUNTERS[2:]]
    m.transcribe_batch(graph_clips(3), options=SamplingOptions(max_tokens=20, **opts))
    got = [c.value - b for c, b in zip(GRAPH_COUNTERS[2:], before)]
    assert got == [0, 0, m.last_loop["decode_steps"]] == [0, 0, 19]


def test_two_concurrent_batches_through_the_batcher(card, monkeypatch):
    """Two worker threads and two gate slots: each batch captures one graph
    of its own and replays it while the other thread dispatches, and each
    batch's texts and confidences are those of the same batch run again
    alone through the eager loop."""
    from qwen3_asr_swift_tpu_torch.serving.batching import ContinuousBatcher

    cfg = dataclasses.replace(config_tiny(), decoder=dataclasses.replace(
        config_tiny().decoder, hidden_size=128, intermediate_size=256, num_heads=4,
        num_kv_heads=2, head_dim=32), encoder=dataclasses.replace(config_tiny().encoder,
                                                                  output_dim=128))
    enc, dec = init_random_params(cfg, 0, quant_bits=4)
    m = Qwen3ASR(cfg, enc, dec, device=card, kv_dtype=torch.int8, audio_buckets_s=(8,),
                 decode_chunk_tokens=15)
    m.transcribe(graph_clips(1)[0], max_tokens=12)   # kernels built, allocator warm
    batches, states = [], {}
    transcribe_batch, gen_chunk = m.transcribe_batch, m._gen_chunk

    def record_batch(audios, **kw):
        out = transcribe_batch(audios, **kw)
        batches.append((list(audios), [(r.text, r.confidence) for r in out]))
        return out

    def record_chunk(state, end, opts):
        states[id(state)] = state
        return gen_chunk(state, end, opts)

    m.transcribe_batch, m._gen_chunk = record_batch, record_chunk
    before = [c.value for c in GRAPH_COUNTERS[2:]]
    batcher = ContinuousBatcher(m, max_batch=4, max_wait_ms=200, workers=2, gate_slots=2)
    try:
        futures = [batcher.submit(c, max_tokens=24) for c in graph_clips(8, seed=2)]
        results = [f.result(timeout=300) for f in futures]
    finally:
        batcher.shutdown()
    captures, replays, eager = [c.value - b for c, b in zip(GRAPH_COUNTERS[2:], before)]
    assert len(results) == 8 and batcher.stats["batches_run"] == len(batches) >= 2
    steps = sum(s.step - 1 for s in states.values())
    assert len(states) == len(batches)
    assert captures == eager == len(batches) and replays == steps - len(batches)
    del m.transcribe_batch, m._gen_chunk
    states.clear()
    monkeypatch.setattr(asr_model, "uses_step_graph", lambda *a: False)
    for audios, got in batches:
        assert [(r.text, r.confidence) for r in m.transcribe_batch(audios, max_tokens=24)] == got
