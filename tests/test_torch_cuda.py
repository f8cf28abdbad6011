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

from qwen3_asr_swift_tpu_torch.core.params import init_random_params
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
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
