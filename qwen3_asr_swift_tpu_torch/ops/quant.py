"""Group-quantized (int2/4/8) linear algebra — port of
``qwen3_asr_swift_tpu/ops/quant.py``.

Param convention (as in the reference): a quantized linear is a dict
``{"codes": int32[out, in*bits/32], "scales": f32[out, in/gs],
"biases": f32[out, in/gs], optional "bias": [out]}`` with MLX codes packed
LSB-first; the codes are the reference's uint32 words viewed as int32
(core/params.py), so every unpack masks after shifting.

Three compute paths over packed weights, as in the reference:

- :func:`quant_matmul` — the plain group decomposition (the
  counterpart of ``quant_matmul_xla``). Prefill-shaped calls take it on
  every device, as the reference leaves them outside Pallas.
- :func:`quant_matmul_cuda` — the wrapper of kernel K1
  (``csrc/quant_matmul.cu``: exact bf16 products on the tensor cores, each
  group's sum scaled in fp32, so the plain version's fp32 function). For a
  CUDA tensor it launches the kernel or raises; only for a CPU tensor does
  it take :func:`quant_matmul`.
- :func:`quant_matmul_plane_cuda` — the wrapper of kernel K2
  (``csrc/quant_matmul_plane.cu``), the reference's per-bit-plane Pallas
  body with its bf16 roundings, on the tensor cores; its plain version is
  :func:`quant_matmul_plane`, and the same CPU/CUDA rule holds.

:func:`quant_linear` and :func:`quant_tied_lm_head` route decode-shaped
calls (at most :data:`KERNEL_MAX_ROWS` activation rows) to the wrapper
that :data:`KERNEL` names, the same row rule and the same
``QUANT_KERNEL`` selection as the reference.

``quant_compute="groupdot"`` repacks the linears once at load
(:func:`repack_tree_groupdot`) and computes them with
:func:`quant_matmul_groupdot`, a library product.
"""

from __future__ import annotations

import os

import torch

from . import cuda_build
from .nn import div_scalar

#: decode-shaped calls (≤ this many activation rows) go to kernel K1 or K2
KERNEL_MAX_ROWS = 256

#: which kernel takes decode-shaped calls: "fused" (K1, the default) or
#: "plane" (K2), read from QUANT_KERNEL at import as the reference reads
#: it; ``_matmul`` reads this constant at call time, so tests may set it
KERNEL = os.environ.get("QUANT_KERNEL", "fused")

#: group sizes kernel K1 takes, with 2-, 4- or 8-bit codes (the MLX packings)
K1_GROUP_SIZES = (32, 64, 128)

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


# ---------------------------------------------------------------------------
# group-dot path (quant_compute="groupdot"): codes unpacked once at load
# ---------------------------------------------------------------------------

def repack_groupdot(p, group_size: int) -> dict:
    """Packed dict → the group-dot layout (the reference's
    ``repack_groupdot``): codes unpacked once to int8 ``[groups, gs, out]``
    (the same 2/4/8-bit values), scales and biases ``[groups, out]`` fp32.
    8-bit codes are recentred to -128..127 and the +128·scale shift folded
    into the group-sum bias term, as the reference does.

    The group size is the caller's: the packed shapes alone do not fix the
    layout (4-bit group 32 has the shapes of 2-bit group 64), and the
    reference's guess, group 64 first, misreads groups 32 and 128."""
    codes = p["codes"]
    scales = p["scales"].float()
    biases = p["biases"].float()
    out_dim, n_groups = scales.shape
    in_dim = n_groups * group_size
    bits, _ = infer_quant_dims(in_dim, codes.shape, scales.shape)
    dense = unpack_codes(codes, bits, in_dim).to(torch.int32)          # [out, in]
    if bits == 8:
        dense = dense - 128
        biases = biases + 128.0 * scales
    out = {"gcodes": dense.to(torch.int8).T.reshape(n_groups, group_size, out_dim).contiguous(),
           "gscales": scales.T.contiguous(),
           "gbiases": biases.T.contiguous()}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quant_matmul_groupdot(x: torch.Tensor, p) -> torch.Tensor:
    """x [..., in] @ dequant(W)^T → fp32 [..., out] over the group-dot
    layout: x is quantized to int8 with a scale per (row, group), sx =
    max|x_g|/127 and xq = round(x/sx) half to even (``torch.round``, as
    ``jnp.round``), and each group's integer partial Σ_k xq·code is scaled
    by sx·scale; the bias term Σ_g β·Σx_g stays exact fp32.

    The partials come from one batched fp32 ``torch.bmm`` over the groups
    (a library product: group-dot is an XLA dot in the reference, not a
    Pallas kernel). Every partial is an integer with |Σ| ≤ gs·127·128 <
    2^24 at the MLX group sizes, and every operand is exact in fp32 (and in
    TF32, whose 11-bit significand holds |code| ≤ 128), so fp32 sums it
    exactly in any order: the reference's int32 result. A bf16 product
    would hold the operands exactly too, but ``bmm`` would round its output
    to bf16."""
    gcodes = p["gcodes"]                                    # [G, gs, out] int8
    n_groups, gs, out_dim = gcodes.shape
    lead = x.shape[:-1]
    xf = x.reshape(-1, n_groups, gs).float()                # [B, G, gs]
    sx = div_scalar(xf.abs().amax(dim=-1).clamp_min(1e-12), 127.0)   # [B, G]
    xq = torch.clamp(torch.round(xf / sx[..., None]), -127, 127)
    partial = torch.bmm(xq.transpose(0, 1), gcodes.float())  # [G, B, out], exact integers
    y = (partial * sx.T[:, :, None] * p["gscales"].float()[:, None, :]).sum(dim=0)
    y = y + xf.sum(dim=-1) @ p["gbiases"].float()
    return y.reshape(*lead, out_dim)


def repack_tree_groupdot(tree, group_size: int):
    """Repack every packed linear of a tree into the group-dot layout;
    packed embedding tables (gathered, and read by the tied LM head) stay
    packed."""

    def walk(node, is_embed=False):
        if isinstance(node, dict):
            if "codes" in node and not is_embed:
                return repack_groupdot(node, group_size)
            return {k: walk(v, is_embed=(k == "embed_tokens")) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)


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


def _launch_packed(x, p, bits: int, gs: int, what: str, fn: str, counter) -> torch.Tensor:
    """Launch a packed-matmul kernel (C entry point ``fn``, its workspace
    size ``fn + "_workspace"``) on a CUDA x [..., in] of bf16 or fp32, which
    it takes as it is (no cast launch); fp32 [..., out] out."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or fp32 x, got {x.dtype}")
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
    n_ws = getattr(lib, fn + "_workspace")(rows, in_dim, n_out, bits, gs, x_bf16)
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device) if n_ws else None   # scratch
    err = getattr(lib, fn)(
        xk.data_ptr(), p["codes"].data_ptr(), p["scales"].data_ptr(), p["biases"].data_ptr(),
        y.data_ptr(), ws.data_ptr() if ws is not None else None, rows, in_dim, n_out, bits, gs,
        x_bf16, cuda_build.stream_handle(x.device))
    cuda_build.check(err, fn)
    counter.add()
    return y.reshape(*x.shape[:-1], n_out)


def quant_matmul_cuda(x: torch.Tensor, p) -> torch.Tensor:
    """Kernel K1: :func:`quant_matmul` of x [..., in] → fp32 [..., out].

    A CPU tensor takes the plain :func:`quant_matmul`; a CUDA tensor
    launches ``qs_quant_matmul`` (csrc/quant_matmul.cu) or raises. x is
    bf16 or fp32 and reaches the kernel as it is (no cast launch): its
    products with the codes are exact on the tensor cores (fp32 x as three
    bf16 terms) and each group's sum takes its scale in fp32. The codes are
    2, 4 or 8 bits in groups of :data:`K1_GROUP_SIZES`."""
    if x.device.type == "cpu":
        return quant_matmul(x, p)
    bits, gs = _kernel_operands(x, p, "quant_matmul_cuda")
    if gs not in K1_GROUP_SIZES:
        raise ValueError(f"K1 takes group sizes {K1_GROUP_SIZES}, got {gs}")
    return _launch_packed(x, p, bits, gs, "quant_matmul_cuda", "qs_quant_matmul", K1_LAUNCHES)


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
    if gs % 32 or (gs * bits) % 128:
        raise ValueError(f"K2 takes a group size that is a multiple of 32 with group*bits a "
                         f"multiple of 128 (group {gs}, bits {bits})")
    return _launch_packed(x, p, bits, gs, "quant_matmul_plane_cuda", "qs_quant_matmul_plane",
                          K2_LAUNCHES)


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


def quantize_mlx_tensor(w: torch.Tensor, bits: int, group_size: int = 64):
    """The reference's ``core.weights.quantize_mlx`` on a tensor of any
    device: w [out, in] → (codes int32 [out, in*bits/32] — the uint32 words
    viewed —, scales fp32 [out, in/gs], biases fp32 [out, in/gs]). The same
    fp32 operations in the same order (group max and min, ``(max-min)/levels``,
    round half to even of ``(w-min)/scale``), so the codes are the numpy
    function's bit for bit."""
    out_dim, in_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"in_dim {in_dim} not divisible by group size {group_size}")
    per_word = 32 // bits
    levels = (1 << bits) - 1
    grouped = w.float().reshape(out_dim, in_dim // group_size, group_size)
    gmax, gmin = grouped.amax(dim=-1), grouped.amin(dim=-1)
    scales = div_scalar(gmax - gmin, levels)
    scales = torch.where(scales == 0, torch.full_like(scales, 1e-8), scales)
    codes = torch.clamp(torch.round((grouped - gmin[..., None]) / scales[..., None]), 0, levels)
    codes = codes.reshape(out_dim, in_dim).to(torch.int64)
    packed = torch.zeros((out_dim, in_dim // per_word), dtype=torch.int64, device=w.device)
    for j in range(per_word):
        packed |= codes[:, j::per_word] << (j * bits)
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed).to(torch.int32)
    return packed.contiguous(), scales.contiguous(), gmin.contiguous()


def quantize_tree(params, bits: int, group_size: int = 64, embed_keys=("embed_tokens",),
                  min_dim: int = 128):
    """Pack every eligible linear of a tree of tensors into the MLX format,
    on the tensors' device (the reference's ``quantize_tree``, which packs
    on the host with numpy): ``{"kernel": [in, out]}`` dicts with in % group
    == 0 and both dims >= ``min_dim``, and ``[vocab, dim]`` tables named in
    ``embed_keys``. Norms, convs and small heads pass through."""

    def pack(w_out_in):
        codes, scales, biases = quantize_mlx_tensor(w_out_in, bits, group_size)
        return {"codes": codes, "scales": scales, "biases": biases}

    def walk(node, name=""):
        if isinstance(node, dict):
            k = node.get("kernel")
            if k is not None and k.dim() == 2:
                d_in, d_out = k.shape
                if d_in % group_size == 0 and d_in >= min_dim and d_out >= min_dim:
                    q = pack(k.T)
                    if "bias" in node:
                        q["bias"] = node["bias"]
                    return q
                return node
            return {k2: walk(v, k2) for k2, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        if (name in embed_keys and isinstance(node, torch.Tensor) and node.dim() == 2
                and node.shape[1] % group_size == 0 and node.shape[1] >= min_dim):
            return pack(node)
        return node

    return walk(params)


def cast_tree(tree, dtype):
    """Float leaves to ``dtype``; packed tensors keep their layout (codes
    int32, group scales and biases fp32; group-dot codes int8), as the
    reference's ``cast_tree``. Integer leaves are never cast."""

    def walk(node):
        if isinstance(node, dict):
            if "gcodes" in node or "codes" in node:
                out = {k: v.float() if k in ("scales", "biases", "gscales", "gbiases") else v
                       for k, v in node.items() if k != "bias"}
                if "bias" in node:
                    out["bias"] = node["bias"].to(dtype)
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node.to(dtype) if node.is_floating_point() else node

    return walk(tree)


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
