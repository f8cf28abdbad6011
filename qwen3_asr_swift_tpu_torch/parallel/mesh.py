"""Process mesh, parameter sharding and the collectives the models use —
port of ``qwen3_asr_swift_tpu/parallel/mesh.py`` over ``torch.distributed``.

The reference runs one process over many devices and lets XLA's
partitioner insert the collectives. Here one process drives one device
(a rank), every rank runs the same code on the same global inputs, and
the collectives are written out where the models need them:

- ``dp``: data parallelism over the batch — each dp row of the mesh takes
  a contiguous slice of the (padded) batch; weights are whole on every row.
  The outputs are gathered over dp, so every rank returns every result.
- ``tp``: tensor parallelism — attention heads and the MLP's intermediate
  width are split column-/row-wise, so a layer needs one sum over tp after
  each row-parallel product; a vocab-sharded embedding sums its masked
  local lookup over tp and the tied head gathers its local logits.
- sequence parallelism: the Qwen3 audio encoder's attention windows never
  attend across a boundary, so one long utterance's windows split over the
  dp ranks (``models/qwen3_asr/encoder.py``) and the tokens are gathered.

Ranks lay out dp-major: rank ``r`` sits at ``(r // tp, r % tp)``, as
``np.asarray(devices).reshape(dp, tp)`` lays out the reference's devices.

The collectives use ``all_reduce`` alone (a gather is a sum of zero-filled
buffers, each rank writing its own slice), so the same code runs under
NCCL on several cards and under gloo, which takes CUDA tensors for
``all_reduce`` but not for ``all_gather``, with several ranks on one card.

:func:`shard_pytree` returns each rank's local slice of every leaf by the
reference's rule tables, with its divisibility fallback to replication and
three checks of the port's own, which the reference's partitioner does not
need because it may insert collectives anywhere:

- heads: an attention projection shards only when its head count divides
  tp (the 0.6B encoder's 14 heads over tp 4 would cut heads in half);
- packed triples: ``codes``/``scales``/``biases`` shard together and only
  on group boundaries; a packed linear the table names only by its dense
  ``/kernel`` takes that rule with the axis transposed (codes are
  ``[out, in']``, kernels ``[in, out]``);
- ties: the projections that feed each other (q/k/v with o, gate/up with
  down) shard together or not at all, so a row-parallel product always
  sees the column-parallel product's local width.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# (path regex, sharded dim) — first match wins; None replicates. Paths are
# "/"-joined keys like "layers/3/mlp/gate_proj/kernel". Copied from the
# reference's PartitionSpecs: P(None, "tp") is dim 1, P("tp", None) dim 0.
QWEN3_DECODER_RULES: Sequence[Tuple[str, Optional[int]]] = (
    (r".*(q_proj|k_proj|v_proj)/kernel$", 1),   # col-parallel
    (r".*o_proj/kernel$", 0),                    # row-parallel
    (r".*(gate_proj|up_proj)/kernel$", 1),
    (r".*down_proj/kernel$", 0),
    (r".*embed_tokens$", 0),                     # vocab-sharded
    # group-quantized variants (ops/quant dicts): codes/scales/biases are
    # [out, packed_in] / [out, groups] — column-parallel shards OUT (dim 0),
    # row-parallel shards the packed input axis (dim 1)
    (r".*(q_proj|k_proj|v_proj|gate_proj|up_proj)/(codes|scales|biases)$", 0),
    (r".*(o_proj|down_proj)/(codes|scales|biases)$", 1),
    (r".*embed_tokens/(codes|scales|biases)$", 0),  # vocab-sharded
    (r".*", None),                               # replicate rest
)

# PersonaPlex 7B (d_model 4096 — the family that actually needs TP).
# Temporal layers share the q/k/v/o + gate/up/down naming; the depformer's
# per-step MultiLinear banks are [steps, in, out] — column-parallel shards
# the out axis (dim 2), row-parallel the in axis (dim 1).
PERSONAPLEX_RULES: Sequence[Tuple[str, Optional[int]]] = (
    (r".*(q_proj|k_proj|v_proj)/kernel$", 1),
    (r".*o_proj/kernel$", 0),
    (r".*(gate_proj|up_proj)/kernel$", 1),
    (r".*down_proj/kernel$", 0),
    (r".*text_head/kernel$", 1),
    (r".*dep_layers/\d+/(in_proj|gating_in)$", 2),
    (r".*dep_layers/\d+/(out_proj|gating_out)$", 1),
    (r".*dep_heads_bank$", 2),
    (r".*", None),
)

QWEN3_ENCODER_RULES: Sequence[Tuple[str, Optional[int]]] = (
    (r".*fc1/kernel$", 1),
    (r".*fc2/kernel$", 0),
    (r".*(q_proj|k_proj|v_proj)/kernel$", 1),
    (r".*out_proj/kernel$", 0),
    (r".*conv_out/kernel$", 1),
    (r".*proj1/kernel$", 1),
    (r".*proj2/kernel$", 0),
    (r".*", None),
)

#: seconds a collective may wait for the other ranks before it raises (a
#: rank that skips a collective would otherwise hang every rank)
COLLECTIVE_TIMEOUT_S = 600


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     device=None) -> None:
    """Join (or make) the default process group. Idempotent: a second call
    is a no-op, as the reference's is.

    ``world_size``/``rank`` default to the ``WORLD_SIZE``/``RANK``
    environment (1 and 0 without it); ``init_method`` to ``env://`` when
    ``MASTER_ADDR`` is set, else to an in-process store (world 1 only).
    ``backend`` defaults to ``"nccl"`` for the card (``device`` None or
    CUDA) and ``"gloo"`` when the caller asks for the CPU. Several ranks on
    one card need ``"gloo"``: NCCL refuses two ranks on one device."""
    if dist.is_initialized():
        return
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if backend is None:
        backend = "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world_size != 1:
            raise ValueError(f"init_distributed: world {world_size} needs an init_method "
                             "(tcp://host:port or file://path) or MASTER_ADDR/MASTER_PORT")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
        return
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout)


@dataclasses.dataclass
class Mesh:
    """This rank's place on a (dp, tp) mesh and the groups of its dp column
    and tp row (None where that axis has one rank)."""

    dp: int
    tp: int
    rank: int
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the tp row (fp32 on the wire, returned in x's dtype)."""
        return _sum(x, self.tp_group) if self.tp > 1 else x

    def tp_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Concatenate the tp row's equal slices of ``dim`` in rank order."""
        return _gather(x, dim, self.tp_rank, self.tp, self.tp_group) if self.tp > 1 else x

    def dp_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Concatenate the dp column's equal slices of ``dim`` in rank order."""
        return _gather(x, dim, self.dp_rank, self.dp, self.dp_group) if self.dp > 1 else x

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank} at "
                f"(dp {self.dp_rank}, tp {self.tp_rank}), backend={dist.get_backend()})")


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """all_reduce SUM; floats travel as fp32 (bf16 partials would round
    before the sum), integers as int64."""
    wire = torch.float32 if x.is_floating_point() and x.dtype != torch.float64 else (
        x.dtype if x.is_floating_point() else torch.int64)
    buf = x.to(wire, copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def _gather(x: torch.Tensor, dim: int, index: int, size: int, group) -> torch.Tensor:
    """all_gather as a sum of zero-filled buffers: exact (every other
    rank adds zeros) and built from all_reduce alone."""
    dim = dim % x.dim()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    full = x.new_zeros(shape)
    full.narrow(dim, index * n, n).copy_(x)
    return _sum(full, group)


def sharded(mesh: Optional[Mesh], local: int, full: int) -> Optional[Mesh]:
    """``mesh`` where a tree holds a tp slice of a width (``local`` of
    ``full``), else None: the part runs whole on this rank."""
    return mesh if mesh is not None and local < full else None


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, device=None) -> Mesh:
    """Build a (dp, tp) mesh over the ranks of the default process group
    (joining a world-1 group first if there is none; ``device`` picks its
    backend, see :func:`init_distributed`). Defaults: every rank on dp.

    Every rank must call this with the same arguments: it makes one group
    for each tp row and each dp column, which every rank joins in order."""
    init_distributed(device=device)
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(
            f"make_mesh needs {n} devices but the process group has {world} ranks; "
            "start one process per device (parallel.launch.spawn, or torchrun) "
            f"with world size {n}")
    if tp is None and dp is None:
        dp, tp = n, 1
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    rank = dist.get_rank()
    tp_group = dp_group = None
    if tp > 1:
        for row in range(dp):
            g = dist.new_group(list(range(row * tp, (row + 1) * tp)))
            if row == rank // tp:
                tp_group = g
    if dp > 1:
        for col in range(tp):
            g = dist.new_group(list(range(col, n, tp)))
            if col == rank % tp:
                dp_group = g
    return Mesh(dp=dp, tp=tp, rank=rank, dp_group=dp_group, tp_group=tp_group)


# --------------------------------------------------------------------------- #
# sharding
# --------------------------------------------------------------------------- #

_PACKED = ("codes", "scales", "biases")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _rule(rules, name: str):
    """(sharded dim or None, whether a rule other than the catch-all matched)."""
    for pat, dim in rules:
        if pat.match(name):
            return dim, pat.pattern != ".*"
    return None, False


def _node(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _plan(tree, mesh: Mesh, rules, heads=(), fused=(), ties=()) -> dict:
    """path → sharded dim for every leaf that shards on this mesh."""
    tp = mesh.tp
    rules = [(re.compile(p), d) for p, d in rules]
    heads = [(re.compile(p), n) for p, n in heads]
    fused = [(re.compile(p), n) for p, n in fused]
    ties = [re.compile(p) for p in ties]
    leaves = dict(_leaves(tree))
    want, can = {}, {}
    for path, leaf in leaves.items():
        name = "/".join(path)
        dim, named = _rule(rules, name)
        parent = path[:-1]
        if path[-1] in _PACKED and not named:
            # a packed triple the table names only by its dense kernel
            kdim, knamed = _rule(rules, "/".join(parent + ("kernel",)))
            if knamed and kdim is not None and leaf.dim() == 2:
                dim = 1 - kdim
        if dim is None:
            continue
        want[path] = dim
        n = leaf.shape[dim] if dim < leaf.dim() else 0
        parts = next((p for pat, p in fused if pat.match(name)), 1)
        ok = n > 0 and n % (parts * tp) == 0
        for pat, n_heads in heads:
            if pat.match(name):
                ok = ok and n_heads % tp == 0
        can[path] = ok
    # a packed triple shards whole (on group boundaries: the scales' fit)
    for path in list(want):
        if path[-1] in _PACKED:
            trio = [path[:-1] + (k,) for k in _PACKED]
            whole = all(t in want and can[t] and want[t] == want[path] for t in trio)
            can[path] = whole
    for pat in ties:
        units = {}
        for path in want:
            m = pat.match("/".join(path))
            if m:
                units.setdefault(m.group(1), []).append(path)
        for members in units.values():
            if not all(can[p] for p in members):
                for p in members:
                    can[p] = False
    plan = {p: want[p] for p in want if can[p]}
    # a column-parallel linear's bias follows its output axis
    for path, dim in list(plan.items()):
        node = _node(tree, path[:-1]) if path[:-1] else None
        if not isinstance(node, dict) or "bias" not in node:
            continue
        col = (path[-1] == "kernel" and dim == leaves[path].dim() - 1) or (
            path[-1] == "codes" and dim == 0)
        if col:
            plan[path[:-1] + ("bias",)] = 0
    return {p: (d, next((n for pat, n in fused if pat.match("/".join(p))), 1))
            for p, d in plan.items()}


def _slice(leaf: torch.Tensor, dim: int, parts: int, index: int, size: int) -> torch.Tensor:
    """This rank's slice of ``dim``: viewed as ``parts`` equal blocks (a
    fused bank such as q|k|v), each block's ``index``-th of ``size`` slices.
    A new contiguous tensor, so the whole leaf can be freed and a kernel
    that needs contiguity takes the slice as it is."""
    n = leaf.shape[dim] // parts
    per = n // size
    pieces = [leaf.narrow(dim, j * n + index * per, per) for j in range(parts)]
    return torch.cat(pieces, dim=dim) if parts > 1 else pieces[0].clone(
        memory_format=torch.contiguous_format)


def shard_pytree(tree, mesh: Mesh, rules, heads: Sequence[Tuple[str, int]] = (),
                 fused: Sequence[Tuple[str, int]] = (), ties: Sequence[str] = ()):
    """This rank's local slice of every leaf of ``tree`` (dicts and lists of
    tensors) by the first rule that matches its path, where tp divides the
    dim; otherwise the leaf is kept whole (replicated).

    ``heads``: (path regex, head count) — the leaf shards only when tp
    divides the head count. ``fused``: (path regex, parts) — the sharded
    dim is that many concatenated blocks, each split over tp. ``ties``:
    path regexes whose first group names a unit; a unit's leaves shard only
    if all of them can. The rows of a dp mesh hold whole copies (the tp
    slices repeat down each dp column)."""
    if mesh.tp == 1:
        return tree
    plan = _plan(tree, mesh, rules, heads, fused, ties)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),)) for i, v in enumerate(node))
        if path in plan:
            dim, parts = plan[path]
            return _slice(node, dim, parts, mesh.tp_rank, mesh.tp)
        return node

    return walk(tree, ())


def replicate(tree, mesh: Mesh):
    """Every leaf whole on every rank (each rank already holds it)."""
    return tree


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a batch of ``n`` padded to a multiple of dp (the
    reference pads with copies of the last clip): the leading batch dim
    sharded over dp, contiguous and in dp-rank order."""
    per = (n + (-n % mesh.dp)) // mesh.dp
    return slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)
