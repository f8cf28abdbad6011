"""NN primitives over parameter trees — port of ``qwen3_asr_swift_tpu/ops/nn.py``.

Params are plain dicts of tensors in the reference's layouts: dense
kernels ``[in, out]``, conv kernels HWIO with NHWC activations at the
public :func:`conv2d`, HIO with NLC activations at :func:`conv1d`.
Matmuls run in the params' dtype and accumulate in fp32 (PyTorch's bf16
GEMMs do); normalization statistics are fp32 (float64 in a float64 run,
the port's own precision reference).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype that statistics, biases and attention are computed in:
    fp32, or float64 in a float64 run."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in :func:`acc_dtype` of its dtype."""
    return x.to(acc_dtype(x.dtype))


@functools.lru_cache(maxsize=None)
def _scalar_on(value: float, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=torch.float32, device=device)


def div_scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` rounded as a true division on every device, as numpy
    and XLA round it: PyTorch's CUDA division by a Python scalar multiplies
    by the scalar's reciprocal, which rounds otherwise. (The divisor is a
    0-d tensor on x's device, made once.)"""
    return x / _scalar_on(float(value), x.device)


def linear(x: torch.Tensor, p) -> torch.Tensor:
    """x @ kernel + bias, or a group-quantized dict (→ ops.quant), or the
    load-time-unpacked group-dot layout {"gcodes", "gscales", "gbiases"}."""
    if "gcodes" in p:
        from .quant import quant_matmul_groupdot

        y = quant_matmul_groupdot(x, p)
        if "bias" in p:
            y = y + p["bias"].float()
        return y.to(x.dtype)
    if "codes" in p:
        from .quant import quant_linear

        return quant_linear(x, p)
    w = p["kernel"]
    if w.dtype != x.dtype:  # e.g. bf16 rows from a packed table into an fp32 kernel
        common = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(common), w.to(common))
    else:
        y = torch.matmul(x, w)
    if "bias" in p:
        y = upcast(y) + upcast(p["bias"])
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = upcast(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * upcast(weight)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    xf = upcast(x)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * upcast(weight) + upcast(bias)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def out_features(p) -> int:
    """Output width of a dense or packed linear (this rank's, if sharded)."""
    return p["codes"].shape[0] if "codes" in p else p["kernel"].shape[-1]


def row_linear(x: torch.Tensor, p, mesh=None) -> torch.Tensor:
    """A row-parallel product: x [..., in/tp] is this rank's slice of the
    input and ``p`` holds the matching rows of W (a dense kernel or a
    packed triple cut on group boundaries); the partial products are summed
    over ``mesh``'s tp row in fp32 and the bias, whole on every rank, is
    added once after the sum. For packed weights this is exact: the group
    term Σ_g β[o,g]·Σx_g splits with the groups. A dense bf16/fp16 partial
    is taken in fp32, so no rank rounds before the sum (the whole product
    rounds once, as it does on one device). ``mesh`` None: :func:`linear`."""
    if mesh is None:
        return linear(x, p)
    if "codes" in p:
        from .quant import _matmul

        y = _matmul(x, p)                       # fp32 (K1 at decode shapes)
    else:
        w = p["kernel"]
        y = torch.matmul(upcast(x), upcast(w)) if x.dtype in (torch.bfloat16, torch.float16) \
            else torch.matmul(x, w.to(x.dtype))
    y = mesh.tp_sum(upcast(y))
    if "bias" in p:
        y = y + upcast(p["bias"])
    return y.to(x.dtype)


def swiglu_mlp(x: torch.Tensor, p, mesh=None) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)), fused ``gate_up_proj`` or separate.
    ``mesh``: gate/up hold this rank's columns and down the matching rows
    (:func:`row_linear`)."""
    if "gate_up_proj" in p:
        gate, up = linear(x, p["gate_up_proj"]).chunk(2, dim=-1)
        return row_linear(silu(gate) * up, p["down_proj"], mesh)
    return row_linear(silu(linear(x, p["gate_proj"])) * linear(x, p["up_proj"]),
                      p["down_proj"], mesh)


def fuse_linears(ps):
    """Concatenate linears fed the same input along the output axis
    (exact for dense and packed params). None when not uniformly fusable."""
    quant = [("codes" in p) for p in ps]
    has_bias = [("bias" in p) for p in ps]
    if any(has_bias) and not all(has_bias):
        return None
    if all(quant):
        fused = {k: torch.cat([p[k] for p in ps], dim=0) for k in ("codes", "scales", "biases")}
    elif not any(quant):
        fused = {"kernel": torch.cat([p["kernel"] for p in ps], dim=1)}
    else:
        return None
    if all(has_bias):
        fused["bias"] = torch.cat([p["bias"] for p in ps], dim=0)
    return fused


def split_linear(p, bounds):
    """Exact inverse of :func:`fuse_linears`: split a linear at output-row
    ``bounds`` (ascending offsets)."""
    lo_hi = list(zip((0,) + tuple(bounds), tuple(bounds) + (None,)))
    if "codes" in p:
        parts = [{k: p[k][lo:hi] for k in ("codes", "scales", "biases")} for lo, hi in lo_hi]
    else:
        parts = [{"kernel": p["kernel"][:, lo:hi]} for lo, hi in lo_hi]
    if "bias" in p:
        for part, (lo, hi) in zip(parts, lo_hi):
            part["bias"] = p["bias"][lo:hi]
    return parts


def fuse_qkv_gate_up(params) -> dict:
    """q/k/v → ``qkv_proj`` and gate/up → ``gate_up_proj`` in every layer."""
    out = dict(params)
    layers = []
    for p in params["layers"]:
        p = dict(p)
        if "q_proj" in p:
            qkv = fuse_linears([p["q_proj"], p["k_proj"], p["v_proj"]])
            if qkv is not None:
                p["qkv_proj"] = qkv
                del p["q_proj"], p["k_proj"], p["v_proj"]
        mlp = dict(p["mlp"])
        if "gate_proj" in mlp:
            gu = fuse_linears([mlp["gate_proj"], mlp["up_proj"]])
            if gu is not None:
                mlp["gate_up_proj"] = gu
                del mlp["gate_proj"], mlp["up_proj"]
                p["mlp"] = mlp
        layers.append(p)
    out["layers"] = layers
    return out


def unfuse_qkv_gate_up(params, q_dim: int, kv_dim: int) -> dict:
    """Exact inverse of :func:`fuse_qkv_gate_up`: slice fused rows back
    into per-projection params (``q_dim`` query rows, ``kv_dim`` key and
    value rows each; the gate/up split is inferred from shapes). No-op on
    already-unfused layers."""
    out = dict(params)
    layers = []
    for p in params["layers"]:
        p = dict(p)
        if "qkv_proj" in p:
            p["q_proj"], p["k_proj"], p["v_proj"] = split_linear(
                p.pop("qkv_proj"), (q_dim, q_dim + kv_dim))
        mlp = dict(p["mlp"])
        if "gate_up_proj" in mlp:
            gu = mlp.pop("gate_up_proj")
            mlp["gate_proj"], mlp["up_proj"] = split_linear(gu, (out_features(gu) // 2,))
            p["mlp"] = mlp
        layers.append(p)
    out["layers"] = layers
    return out


def table_rows(table) -> int:
    """Rows of an embedding table, dense or packed (this rank's, if sharded)."""
    return (table["codes"] if isinstance(table, dict) else table).shape[0]


def embedding_lookup(table, ids: torch.Tensor, dim: Optional[int] = None,
                     mesh=None) -> torch.Tensor:
    """table [vocab, dim], or a packed table dict (then ``dim`` is required
    and the rows come back in bf16, as the reference's
    ``quant_embedding_lookup`` returns them whatever the model dtype);
    ids integer [...]. ``mesh``: the table holds this tp rank's contiguous
    vocab shard; ids outside it read zeros and the rows are summed over tp
    (one rank adds its row, the others zeros: exact)."""
    if mesh is not None:
        n = table_rows(table)
        local = ids.long() - mesh.tp_rank * n
        inside = (local >= 0) & (local < n)
        rows = embedding_lookup(table, local.clamp(0, n - 1), dim)
        return mesh.tp_sum(torch.where(inside[..., None], rows, torch.zeros_like(rows)))
    if isinstance(table, dict) and "codes" in table:
        from .quant import quant_embedding_lookup

        return quant_embedding_lookup(table, ids, dim)
    return table[ids.long()]


def tied_lm_head(hidden: torch.Tensor, table, mesh=None) -> torch.Tensor:
    """Embedding table reused as the LM head; fp32 logits. ``mesh``: the
    table holds this tp rank's vocab shard, and the local logits are
    gathered over tp into the whole vocabulary."""
    if isinstance(table, dict) and "codes" in table:
        from .quant import quant_tied_lm_head

        logits = quant_tied_lm_head(hidden, table)
    else:
        logits = torch.matmul(hidden, table.T).float()
    return logits if mesh is None else mesh.tp_gather(logits, dim=-1)


def lstm_loop(gx: torch.Tensor, wh: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """W LSTMs' recurrences stepped together, one loop of device ops (each
    BiLSTM direction, or each weight set, one entry of a batched product):
    gx [W, T, B, 4h] holds every step's input product x·wx, taken before
    the loop; wh [W, h, 4h]; bias [W, 4h] → hidden states [W, T, B, h].
    Torch gate order i, f, g, o; a step sums (x·wx + h·wh) + bias, as the
    reference's scans do."""
    h = gx.new_zeros((gx.shape[0], gx.shape[2], wh.shape[1]))
    c = torch.zeros_like(h)
    bias = bias[:, None]
    ys = []
    for step in range(gx.shape[1]):
        gates = torch.baddbmm(gx[:, step], h, wh) + bias
        i, f, _, o = torch.sigmoid(gates).chunk(4, dim=-1)
        c = f * c + i * torch.tanh(gates.chunk(4, dim=-1)[2])
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1)


def conv1d(x: torch.Tensor, p, stride: int = 1, padding=0, groups: int = 1,
           dilation: int = 1) -> torch.Tensor:
    """NLC conv1d with the reference's layout, p: {"kernel": [width,
    in//groups, out] (HIO), optional "bias": [out]}; ``padding`` an int or
    ``((lo, hi),)``; fp32 bias.

    bf16 and fp16 go to ``F.conv1d`` (fp32 accumulation, one rounding).
    fp32 and float64 are a sum over the kernel's taps of one strided
    product each into one buffer: full precision (fp32 matmuls are not
    TF32 by default, cuDNN's fp32 convs are, and no process-wide flag is
    set), no window matrix, and each product sums over the input channels
    of one tap alone, so a long kernel's sums are taken in width short runs
    on the card as on the host. A single-channel signal (an STFT's frames)
    is one product over its unfolded windows instead: the same width-term
    sums, one launch rather than width."""
    if isinstance(padding, int):
        padding = ((padding, padding),)
    ((lo, hi),) = padding
    k = p["kernel"].to(x.dtype)
    width, cin_g, cout = k.shape
    b = x.shape[0]
    xp = F.pad(x, (0, 0, lo, hi))
    if x.dtype in (torch.bfloat16, torch.float16):
        y = F.conv1d(xp.transpose(1, 2), k.permute(2, 1, 0), stride=stride, dilation=dilation,
                     groups=groups).transpose(1, 2)
    elif cin_g * groups == 1:
        win = xp[..., 0].unfold(1, (width - 1) * dilation + 1, stride)[..., ::dilation]
        y = win @ k[:, 0]                                       # [B, L', width] @ [width, out]
    else:
        n = (xp.shape[1] - (width - 1) * dilation - 1) // stride + 1
        depthwise = cin_g == 1 and cout == groups
        if groups == 1:
            y = x.new_zeros((b * n, cout))
        elif depthwise:
            y = x.new_zeros((b, n, cout))
        else:
            y = x.new_zeros((groups, b * n, cout // groups))
            kg = k.reshape(width, cin_g, groups, cout // groups).transpose(1, 2)
        for j in range(width):
            tap = xp[:, j * dilation: j * dilation + stride * (n - 1) + 1: stride]
            if groups == 1:
                y.addmm_(tap.reshape(b * n, cin_g), k[j])
            elif depthwise:
                y.addcmul_(tap, k[j, 0])
            else:
                y.baddbmm_(tap.reshape(b * n, groups, cin_g).transpose(0, 1), kg[j])
        if not depthwise:
            y = (y if groups == 1 else y.transpose(0, 1)).reshape(b, n, cout)
    if "bias" in p:
        y = upcast(y) + upcast(p["bias"])
    return y.to(x.dtype)


def conv_transpose1d_full(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """The reference's transposed conv as ``lax.conv_transpose`` (VALID) or
    an lhs-dilated conv padded K-1 a side computes it, without its bias:
    NLC x, kernel [K, in//groups, out] with the taps as the reference's
    converters store them (flipped); (T-1)·stride + K samples, each tap one
    product of the input overlap-added at its offset in :func:`acc_dtype`
    (one tap's product live at a time). The groups follow from the
    kernel's shape."""
    k, in_per, out_total = kernel.shape
    b, t, c = x.shape
    g = c // in_per
    w = kernel.flip(0).to(x.dtype)
    n = (t - 1) * stride + k
    y = x.new_zeros((b, n, out_total), dtype=acc_dtype(x.dtype))
    for tap in range(k):
        if g == 1:
            z = x @ w[tap]
        elif in_per == 1 and out_total == g:                    # depthwise
            z = x * w[tap, 0]
        else:
            z = torch.einsum("btgi,igo->btgo", x.reshape(b, t, g, in_per),
                             w[tap].reshape(in_per, g, out_total // g)).reshape(b, t, out_total)
        y[:, tap: tap + (t - 1) * stride + 1: stride] += z
    return y


def _conv2d_taps(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """NCHW conv as a sum over the kh·kw taps of shifted 1×1 products (one
    matmul per tap into one output buffer), w HWIO: full-precision matmuls,
    with no window matrix (kh·kw times the input) ever built."""
    kh, kw, cin, cout = w.shape
    (sh, sw), (ph, pw) = stride, padding
    b, _, h, wd = x.shape
    ho, wo = (h + 2 * ph - kh) // sh + 1, (wd + 2 * pw - kw) // sw + 1
    xp = F.pad(x, (pw, pw, ph, ph)).permute(0, 2, 3, 1)           # [B, Hp, Wp, C]
    y = torch.zeros((b * ho * wo, cout), dtype=x.dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
            y.addmm_(tap.reshape(b * ho * wo, cin), w[i, j])
    return y.reshape(b, ho, wo, cout).permute(0, 3, 1, 2)


def conv2d_nchw(x: torch.Tensor, p, stride=(2, 2), padding=(1, 1)) -> torch.Tensor:
    """NCHW conv with the reference's HWIO kernel and fp32 bias. bf16 and
    fp16 go to ``F.conv2d``; fp32 is a sum of tap matmuls
    (:func:`_conv2d_taps`), because cuDNN's fp32 convs default to TF32 and
    fp32 matmuls do not, so no process-wide flag is set."""
    if x.dtype in (torch.bfloat16, torch.float16):
        w = p["kernel"].permute(3, 2, 0, 1)  # HWIO → OIHW
        y = F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)
    else:
        y = _conv2d_taps(x, p["kernel"].to(x.dtype), stride, padding)
    if "bias" in p:
        y = (upcast(y) + upcast(p["bias"])[:, None, None]).to(x.dtype)
    return y


def depthwise_conv2d(x: torch.Tensor, p, stride=(1, 1), padding=((0, 0), (0, 0))) -> torch.Tensor:
    """NHWC depthwise conv (the reference's ``feature_group_count`` equal to
    the channels), p: {"kernel": [kh, kw, 1, C] (HWIO), optional "bias":
    [C]}; ``padding`` ((top, bottom), (left, right)); fp32 bias. fp32 and
    float64 are a sum over the kh·kw taps of one shifted elementwise
    product each into one buffer: exact products with no matmul and no
    cuDNN (whose fp32 convs default to TF32). bf16 and fp16 go to
    ``F.conv2d(groups=C)``."""
    k = p["kernel"].to(x.dtype)
    kh, kw, _, c = k.shape
    sh, sw = stride
    (pt, pb), (pl, pr) = padding
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    if x.dtype in (torch.bfloat16, torch.float16):
        y = F.conv2d(xp.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), stride=stride,
                     groups=c).permute(0, 2, 3, 1)
    else:
        b, hp, wp, _ = xp.shape
        ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
        y = x.new_zeros((b, ho, wo, c))
        for i in range(kh):
            for j in range(kw):
                y.addcmul_(xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw],
                           k[i, j, 0])
    if "bias" in p:
        y = upcast(y) + upcast(p["bias"])
    return y.to(x.dtype)


def conv2d(x: torch.Tensor, p, stride=(1, 1), padding=((1, 1), (1, 1))) -> torch.Tensor:
    """NHWC conv, p: {"kernel": HWIO, optional "bias": [O]} — the
    reference's public layout. Symmetric padding only."""
    (ph0, ph1), (pw0, pw1) = padding
    if ph0 != ph1 or pw0 != pw1:
        raise ValueError(f"asymmetric padding {padding} is not supported")
    y = conv2d_nchw(x.permute(0, 3, 1, 2), p, stride=stride, padding=(ph0, pw0))
    return y.permute(0, 2, 3, 1)
