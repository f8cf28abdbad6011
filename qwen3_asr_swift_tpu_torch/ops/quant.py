"""Group-quantized (int2/4/8) linear algebra — port of
``qwen3_asr_swift_tpu/ops/quant.py``.

Param convention (as in the reference): a quantized linear is a dict
``{"codes": int32[out, in*bits/32], "scales": f32[out, in/gs],
"biases": f32[out, in/gs], optional "bias": [out]}`` with MLX codes packed
LSB-first; the codes are the reference's uint32 words viewed as int32
(core/params.py), so every unpack masks after shifting.

Three compute paths, as in the reference:

- :func:`quant_matmul` — the plain group decomposition (the
  counterpart of ``quant_matmul_xla``). Prefill-shaped calls take it on
  every device, as the reference leaves them outside Pallas.
- :func:`quant_matmul_cuda` — the wrapper of kernel K1
  (``csrc/quant_matmul.cu``, fp32 throughout). For a CUDA tensor it
  launches the kernel or raises; only for a CPU tensor does it take
  :func:`quant_matmul`.
- :func:`quant_matmul_plane_cuda` — the wrapper of kernel K2
  (``csrc/quant_matmul_plane.cu``), the reference's per-bit-plane Pallas
  body with its bf16 roundings, on the tensor cores; its plain version is
  :func:`quant_matmul_plane`, and the same CPU/CUDA rule holds.

:func:`quant_linear` and :func:`quant_tied_lm_head` route decode-shaped
calls (at most :data:`KERNEL_MAX_ROWS` activation rows) to the wrapper
that :data:`KERNEL` names, the same row rule and the same
``QUANT_KERNEL`` selection as the reference.
"""

from __future__ import annotations

import os

import torch

from . import cuda_build

#: decode-shaped calls (≤ this many activation rows) go to kernel K1 or K2
KERNEL_MAX_ROWS = 256

#: which kernel takes decode-shaped calls: "fused" (K1, the default) or
#: "plane" (K2), read from QUANT_KERNEL at import as the reference reads
#: it; ``_matmul`` reads this constant at call time, so tests may set it
KERNEL = os.environ.get("QUANT_KERNEL", "fused")

#: launches of kernel K1
K1_LAUNCHES = cuda_build.LaunchCounter("quant_matmul_cuda")
#: launches of kernel K2
K2_LAUNCHES = cuda_build.LaunchCounter("quant_matmul_plane_cuda")


def infer_quant_dims(in_dim: int, codes_shape, scales_shape):
    """(bits, group_size) from static shapes."""
    packed = codes_shape[-1]
    groups = scales_shape[-1]
    bits = (32 * packed) // in_dim
    if bits not in (2, 4, 8) or (32 * packed) % in_dim:
        raise ValueError(f"cannot infer bits: in={in_dim} packed={packed}")
    if in_dim % groups:
        raise ValueError(f"cannot infer group size: in={in_dim} groups={groups}")
    return bits, in_dim // groups


def unpack_codes(codes: torch.Tensor, bits: int, in_dim: int) -> torch.Tensor:
    """int32 words [..., in*bits/32] → float32 codes [..., in] (LSB-first)."""
    per_word = 32 // bits
    shifts = torch.arange(per_word, device=codes.device, dtype=torch.int32) * bits
    u = (codes[..., :, None] >> shifts) & ((1 << bits) - 1)  # mask after the shift
    return u.reshape(*codes.shape[:-1], in_dim).to(torch.float32)


def dequantize(p, in_dim: int, dtype=torch.float32) -> torch.Tensor:
    """Materialize the dense [out, in] weight."""
    bits, gs = infer_quant_dims(in_dim, p["codes"].shape, p["scales"].shape)
    c = unpack_codes(p["codes"], bits, in_dim)
    s = torch.repeat_interleave(p["scales"].float(), gs, dim=-1)
    b = torch.repeat_interleave(p["biases"].float(), gs, dim=-1)
    return (c * s + b).to(dtype)


def quant_matmul(x: torch.Tensor, p) -> torch.Tensor:
    """x [..., in] @ dequant(W)^T → fp32 [..., out], the group
    decomposition of the reference's ``quant_matmul_xla`` with each group's
    scale folded into its codes: ``y = x·(s⊙c)ᵀ + Σ_g β[o,g]·Σx_g``. The
    bias term stays an exact product of group sums; folding the scale
    first changes only fp32 rounding, and turns the per-group partials
    into one GEMM (no [rows, groups, out] intermediate at prefill)."""
    in_dim = x.shape[-1]
    bits, gs = infer_quant_dims(in_dim, p["codes"].shape, p["scales"].shape)
    lead = x.shape[:-1]
    xf = x.reshape(-1, in_dim).to(torch.float32)
    scaled = unpack_codes(p["codes"], bits, in_dim)                          # [out, in]
    scaled *= torch.repeat_interleave(p["scales"].float(), gs, dim=-1)
    xsum = xf.reshape(xf.shape[0], in_dim // gs, gs).sum(dim=-1)            # [B, G]
    y = torch.addmm(xsum @ p["biases"].float().T, xf, scaled.T)
    return y.reshape(*lead, -1)


def quant_matmul_plane(x: torch.Tensor, p) -> torch.Tensor:
    """x [..., in] @ dequant(W)^T → fp32 [..., out], the function of the
    reference's per-bit-plane Pallas body (``_quant_matmul_kernel``) with
    its roundings: x and the expanded group scale are cast to bf16, each
    ``bf16(code) · bf16(scale)`` product is rounded to bf16, and the bias
    term ``Σ_g β[o,g]·Σx_g`` comes from the unrounded x (fp32 group sums).
    The products (exact in fp32: bf16 × bf16) are summed in float64 and
    rounded once to fp32, so, like the kernel's fixed per-output order, the
    result depends neither on a GEMM's summation order nor on how many rows
    share the call; the pool and the solo path see the same row."""
    in_dim = x.shape[-1]
    bits, gs = infer_quant_dims(in_dim, p["codes"].shape, p["scales"].shape)
    lead = x.shape[:-1]
    xf = x.reshape(-1, in_dim).to(torch.float32)
    s_exp = torch.repeat_interleave(p["scales"].float(), gs, dim=-1).to(torch.bfloat16)
    w = unpack_codes(p["codes"], bits, in_dim).to(torch.bfloat16) * s_exp   # bf16 rounding
    xsum = xf.reshape(xf.shape[0], in_dim // gs, gs).sum(dim=-1)            # [B, G] fp32
    y = torch.addmm(xsum.double() @ p["biases"].double().T,
                    xf.to(torch.bfloat16).double(), w.double().T)
    return y.float().reshape(*lead, -1)


def _check_kernel_args(x, p):
    codes, scales, biases = p["codes"], p["scales"], p["biases"]
    for name, t in (("codes", codes), ("scales", scales), ("biases", biases)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32 (uint32 words viewed), got {codes.dtype}")
    if scales.dtype != torch.float32 or biases.dtype != torch.float32:
        raise TypeError("scales and biases must be float32")
    if codes.dim() != 2 or scales.shape != biases.shape or scales.shape[0] != codes.shape[0]:
        raise ValueError(f"bad shapes codes {tuple(codes.shape)} scales "
                         f"{tuple(scales.shape)} biases {tuple(biases.shape)}")


def _kernel_operands(x, p, what: str):
    """What both kernels' wrappers check on a CUDA tensor. Returns (bits,
    group size)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    bits, gs = infer_quant_dims(x.shape[-1], p["codes"].shape, p["scales"].shape)
    _check_kernel_args(x, p)
    return bits, gs


def quant_matmul_cuda(x: torch.Tensor, p) -> torch.Tensor:
    """Kernel K1: x [..., in] @ dequant(W)^T → fp32 [..., out].

    A CPU tensor takes the plain :func:`quant_matmul`; a CUDA tensor
    launches ``qs_quant_matmul`` (csrc/quant_matmul.cu) or raises."""
    if x.device.type == "cpu":
        return quant_matmul(x, p)
    bits, gs = _kernel_operands(x, p, "quant_matmul_cuda")
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    (rows, in_dim), n_out = xf.shape, p["codes"].shape[0]
    y = torch.empty((rows, n_out), dtype=torch.float32, device=x.device)
    err = cuda_build.library().qs_quant_matmul(
        xf.data_ptr(), p["codes"].data_ptr(), p["scales"].data_ptr(),
        p["biases"].data_ptr(), y.data_ptr(), rows, in_dim, n_out, bits, gs,
        cuda_build.stream_handle(x.device))
    cuda_build.check(err, "qs_quant_matmul")
    K1_LAUNCHES.add()
    return y.reshape(*x.shape[:-1], n_out)


def quant_matmul_plane_cuda(x: torch.Tensor, p) -> torch.Tensor:
    """Kernel K2: :func:`quant_matmul_plane` of x [..., in] → fp32 [..., out].

    A CPU tensor takes the plain :func:`quant_matmul_plane`; a CUDA tensor
    launches ``qs_quant_matmul_plane`` (csrc/quant_matmul_plane.cu) or
    raises. x is bf16 or fp32 and reaches the kernel as it is (no cast
    launch): the kernel rounds it to bf16 and sums its groups in fp32 in
    registers. The group size must be a multiple of 32 with ``group·bits``
    a multiple of 128, so every mma's 32 inputs lie in one group and a
    group's codes are whole 16-byte copies."""
    if x.device.type == "cpu":
        return quant_matmul_plane(x, p)
    bits, gs = _kernel_operands(x, p, "quant_matmul_plane_cuda")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant_matmul_plane_cuda takes bf16 or fp32 x, got {x.dtype}")
    if gs % 32 or (gs * bits) % 128:
        raise ValueError(f"K2 takes a group size that is a multiple of 32 with group*bits a "
                         f"multiple of 128 (group {gs}, bits {bits})")
    if p["codes"].data_ptr() % 16:
        raise ValueError("codes must be 16-byte aligned")
    in_dim, n_out = x.shape[-1], p["codes"].shape[0]
    xk = x.reshape(-1, in_dim).contiguous()
    if xk.data_ptr() % 16:
        xk = xk.clone()
    rows = xk.shape[0]
    lib = cuda_build.library()
    y = torch.empty((rows, n_out), dtype=torch.float32, device=x.device)
    x_bf16 = int(xk.dtype == torch.bfloat16)
    n_ws = lib.qs_quant_matmul_plane_workspace(rows, in_dim, n_out, bits, gs, x_bf16)
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device) if n_ws else None   # scratch
    err = lib.qs_quant_matmul_plane(
        xk.data_ptr(), p["codes"].data_ptr(), p["scales"].data_ptr(), p["biases"].data_ptr(),
        y.data_ptr(), ws.data_ptr() if ws is not None else None, rows, in_dim, n_out, bits, gs,
        x_bf16, cuda_build.stream_handle(x.device))
    cuda_build.check(err, "qs_quant_matmul_plane")
    K2_LAUNCHES.add()
    return y.reshape(*x.shape[:-1], n_out)


def _rows(x) -> int:
    n = 1
    for d in x.shape[:-1]:
        n *= int(d)
    return n


def _matmul(x, p):
    if KERNEL not in ("fused", "plane"):
        raise ValueError(f"QUANT_KERNEL must be 'fused' or 'plane', got {KERNEL!r}")
    if _rows(x) > KERNEL_MAX_ROWS:
        return quant_matmul(x, p)
    if KERNEL == "plane":
        return quant_matmul_plane_cuda(x, p)
    return quant_matmul_cuda(x, p)


def quant_linear(x: torch.Tensor, p) -> torch.Tensor:
    """Quantized y = x @ W^T (+ bias), in x's dtype."""
    y = _matmul(x, p)
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def quant_tied_lm_head(hidden: torch.Tensor, p) -> torch.Tensor:
    """logits = hidden @ dequant(table)^T, fp32 (out = vocab)."""
    return _matmul(hidden, p)


def quant_embedding_lookup(p, ids: torch.Tensor, dim: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Gather + dequantize rows of a quantized table. ids [...] → [..., dim]."""
    bits, gs = infer_quant_dims(dim, p["codes"].shape, p["scales"].shape)
    ids = ids.long()
    c = unpack_codes(p["codes"][ids], bits, dim)
    s = torch.repeat_interleave(p["scales"][ids].float(), gs, dim=-1)
    b = torch.repeat_interleave(p["biases"][ids].float(), gs, dim=-1)
    return (c * s + b).to(dtype)


def dequantize_tree(params, bits: int, group_size: int = 64, dtype=torch.bfloat16,
                    embed_keys=("embed_tokens",)):
    """Every packed tensor back to dense ``dtype`` (the reference's
    ``dequantize_tree``): linears become ``{"kernel": [in, out]}``, tables
    named in ``embed_keys`` dense ``[vocab, dim]``."""

    def walk(node, name=""):
        if isinstance(node, dict):
            if "codes" in node:
                in_dim = node["codes"].shape[-1] * 32 // bits
                got = infer_quant_dims(in_dim, node["codes"].shape, node["scales"].shape)
                if got != (bits, group_size):
                    raise ValueError(f"packing mismatch at {name!r}: tree is {got[0]}-bit "
                                     f"group-{got[1]}, caller said {bits}-bit group-{group_size}")
                w = dequantize(node, in_dim, dtype)
                if name in embed_keys:
                    return w
                out = {"kernel": w.T.contiguous()}
                if "bias" in node:
                    out["bias"] = node["bias"].to(dtype)
                return out
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return node

    return walk(params)
