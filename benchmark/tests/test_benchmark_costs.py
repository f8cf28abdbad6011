"""The yardstick's operation and byte counts against sums by hand."""

import json

import pytest

from conftest import REPO
from benchmark.costs import qwen3_asr as costs

PEAKS = {"bf16_flops_s": 989e12, "hbm_bytes_s": 3.35e12}


def config(name):
    with open(REPO / "benchmark" / "configs" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name, product, rows, want_bytes, want_flops", [
    # 0.6B q|k|v: in 1024, out 4096, 4-bit: codes 1024*4096/2, 16 groups of
    # fp32 scale and bias a row, bf16 x, fp32 y
    ("qwen3-asr-0.6b-4bit", "qkv", 128,
     2_097_152 + 524_288 + 262_144 + 2_097_152, 2 * 128 * 1024 * 4096),
    # 1.7B gate|up: in 2048, out 12288, 8-bit: 32 groups
    ("qwen3-asr-1.7b-8bit", "gate_up", 128,
     25_165_824 + 3_145_728 + 524_288 + 6_291_456, 6_442_450_944),
    # 0.6B head: in 1024, out 151936, one row
    ("qwen3-asr-0.6b-4bit", "head", 1,
     77_791_232 + 19_447_808 + 2_048 + 607_744, 2 * 1024 * 151936),
])
def test_packed_product(name, product, rows, want_bytes, want_flops):
    cfg = config(name)
    (d_in, d_out), = [(i, o) for n, i, o, _ in costs.decode_products(cfg) if n == product]
    got_bytes, got_flops = costs.packed_product(cfg, rows, d_in, d_out)
    assert got_bytes == want_bytes and got_flops == want_flops


def test_decode_products_and_launches():
    small, large = config("qwen3-asr-0.6b-4bit"), config("qwen3-asr-1.7b-8bit")
    assert costs.decode_products(small) == [("qkv", 1024, 4096, 28), ("o", 2048, 1024, 28),
                                            ("gate_up", 1024, 6144, 28),
                                            ("down", 3072, 1024, 28),
                                            ("head", 1024, 151936, 1)]
    assert costs.decode_products(large)[2] == ("gate_up", 2048, 12288, 28)
    assert costs.k1_decode_launches(small, 99) == 99 * 113


def test_k3_call():
    cfg = config("qwen3-asr-0.6b-4bit")
    # rows with 100 and 50 valid slots: 8 kv heads of int8 k and v (2*128
    # bytes) and two fp32 scales a slot; bf16 q and out of 16 heads; the
    # [2, 200] valid map
    n_bytes, flops = costs.k3_call(cfg, [100, 50], 200)
    assert n_bytes == 150 * 8 * 264 + 2 * 2 * 2 * 16 * 128 + 400
    assert flops == 4 * 16 * 128 * 150


@pytest.mark.parametrize("seconds, samples, tokens", [(30, 480000, 390), (8, 128000, 104),
                                                      (5.37, 85920, 70)])
def test_audio_tokens(seconds, samples, tokens):
    cfg = config("qwen3-asr-0.6b-4bit")
    assert costs.audio_tokens(cfg, samples) == tokens
    assert costs.prompt_rows(cfg, samples) == 9 + tokens + 7


def test_encoder_flops_of_one_window():
    """8 s: 8 chunks, 104 tokens, one attention window."""
    cfg = config("qwen3-asr-0.6b-4bit")
    conv = 2 * 9 * 480 * (64 * 50 + 480 * 32 * 25 + 480 * 16 * 13) * 8
    layer = 104 * 2 * (4 * 896 ** 2 + 2 * 896 * 3584) + 4 * 104 * 104 * 896
    post = 104 * 2 * (7680 * 896 + 896 * 896 + 896 * 1024)
    assert costs.encoder_flops(cfg, 128000) == conv + 18 * layer + post


def test_decoder_flops():
    cfg = config("qwen3-asr-0.6b-4bit")
    lin = 2 * 28 * (1024 * 4096 + 2048 * 1024 + 1024 * 6144 + 3072 * 1024)
    attn = 4 * 16 * 128 * 28
    head = 2 * 1024 * 151936
    want = 10 * lin + attn * 55 + head + 2 * (lin + head) + attn * (11 + 12)
    assert costs.decoder_flops(cfg, 10, 2) == want


def test_bound_takes_the_larger():
    assert costs.bound_s(3.35e12, 1.0, PEAKS) == pytest.approx(1.0)
    assert costs.bound_s(1.0, 989e12, PEAKS) == pytest.approx(1.0)
