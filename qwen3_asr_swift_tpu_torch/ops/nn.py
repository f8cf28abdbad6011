"""NN primitives over parameter trees — port of ``qwen3_asr_swift_tpu/ops/nn.py``.

Params are plain dicts of tensors in the reference's layouts: dense
kernels ``[in, out]``, conv kernels HWIO with NHWC activations at the
public :func:`conv2d`. Matmuls run in the params' dtype and accumulate in
fp32 (PyTorch's bf16 GEMMs do); normalization statistics are fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, p) -> torch.Tensor:
    """x @ kernel + bias, or a group-quantized dict (→ ops.quant)."""
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
        y = y.float() + p["bias"].float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def swiglu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)), fused ``gate_up_proj`` or separate."""
    if "gate_up_proj" in p:
        gate, up = linear(x, p["gate_up_proj"]).chunk(2, dim=-1)
        return linear(silu(gate) * up, p["down_proj"])
    return linear(silu(linear(x, p["gate_proj"])) * linear(x, p["up_proj"]), p["down_proj"])


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


def embedding_lookup(table, ids: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """table [vocab, dim], or a packed table dict (then ``dim`` is required
    and the rows come back in bf16, as the reference's
    ``quant_embedding_lookup`` returns them whatever the model dtype);
    ids integer [...]."""
    if isinstance(table, dict) and "codes" in table:
        from .quant import quant_embedding_lookup

        return quant_embedding_lookup(table, ids, dim)
    return table[ids.long()]


def tied_lm_head(hidden: torch.Tensor, table) -> torch.Tensor:
    """Embedding table reused as the LM head; fp32 logits."""
    if isinstance(table, dict) and "codes" in table:
        from .quant import quant_tied_lm_head

        return quant_tied_lm_head(hidden, table)
    return torch.matmul(hidden, table.T).float()


def conv2d_nchw(x: torch.Tensor, p, stride=(2, 2), padding=(1, 1)) -> torch.Tensor:
    """NCHW conv with the reference's HWIO kernel (permuted per call — the
    kernels are small) and fp32 bias."""
    w = p["kernel"].permute(3, 2, 0, 1)  # HWIO → OIHW
    y = F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)
    if "bias" in p:
        y = (y.float() + p["bias"].float()[:, None, None]).to(x.dtype)
    return y


def conv2d(x: torch.Tensor, p, stride=(1, 1), padding=((1, 1), (1, 1))) -> torch.Tensor:
    """NHWC conv, p: {"kernel": HWIO, optional "bias": [O]} — the
    reference's public layout. Symmetric padding only."""
    (ph0, ph1), (pw0, pw1) = padding
    if ph0 != ph1 or pw0 != pw1:
        raise ValueError(f"asymmetric padding {padding} is not supported")
    y = conv2d_nchw(x.permute(0, 3, 1, 2), p, stride=stride, padding=(ph0, pw0))
    return y.permute(0, 2, 3, 1)
