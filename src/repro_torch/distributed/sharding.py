"""Logical-axis -> mesh-axis sharding rules with divisibility fallback.

Port of `repro.distributed.sharding`.  The mesh hierarchy mirrors the
paper's NoC hierarchy:
    "model" axis  <-> the 20-core level-1 fullerene domain (TP/EP)
    "data"  axis  <-> level-1 router-parallel traffic (DP/FSDP)
    "pod"   axis  <-> the level-2 router scale-up path (multi-pod DP)

Rules map a logical axis name to an ordered list of candidate mesh axes;
the first candidate whose size divides the tensor dimension (and is not
already used by another dim of the same tensor) wins, else the dim is
replicated.  This keeps every sharding legal for every architecture
(e.g. 8 kv heads on a 16-way model axis fall back cleanly).

The reference's GSPMD `PartitionSpec` is the port's `PartitionSpec`, a
tuple with one entry per tensor dim (a mesh axis name, a tuple of names
for a compound sharding, or None); `placements(spec, mesh)` turns it into
DTensor placements on a `DeviceMesh` whose dim names are the mesh axes.
A compound ("pod", "data") entry shards the dim over both mesh dims,
pod-major: the flattened submesh.  A "mesh" here is a `DeviceMesh` or a
plain {axis: size} mapping (enough for the specs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

# Candidates per logical axis, in preference order.  Tuples are compound
# (multi-axis) shardings.
DEFAULT_RULES: dict[str, list] = {
    "layers": [],
    "vocab": ["model"],
    "heads": ["model"],
    "kv_heads": ["model"],
    "mlp": ["model"],
    "experts": ["model"],
    "embed": [("pod", "data"), "data"],       # FSDP / ZeRO-3 axis
    "batch": [("pod", "data"), "data"],
    "seq": ["model"],                          # sequence parallelism
    "cache_batch": [("pod", "data"), "data"],
    "cache_heads": ["model"],
    "cache_seq": ["model"],                    # flash-decoding fallback
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Any = None

    def get(self, logical: str | None) -> list:
        if logical is None:
            return []
        table = self.rules or DEFAULT_RULES
        return table.get(logical, [])


# Pure ZeRO-3: no TP/SP — params and batch sharded over ALL axes jointly.
FSDP_RULES = dict(
    DEFAULT_RULES,
    vocab=[], heads=[], kv_heads=[], mlp=[], experts=[], seq=[],
    embed=[("pod", "data", "model"), ("data", "model"), "data"],
    batch=[("pod", "data", "model"), ("data", "model"), "data"],
)


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (replicated).  `P("data", None) == ("data", None)`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def rules_of(constraint) -> ShardingRules:
    """The rules a forward's `constraint` was made with (the attribute
    `make_residual_constraint` sets): the layouts the model's mesh-aware
    ops (the attention's `local_map`, the vocab-parallel loss) follow.
    Any other constraint, or None, gives the default rules."""
    return getattr(constraint, "rules", ShardingRules())


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def full(t):
    """A DTensor's full value as a plain tensor, the same on every rank (a
    sharded one gathered, a partial one reduced); a plain tensor as it
    is."""
    return t.full_tensor() if is_dtensor(t) else t


def replicated(t, mesh):
    """A plain tensor (the same on every rank) as a DTensor replicated on
    `mesh`; a DTensor as it is."""
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _axis_size(sizes: dict, axis) -> int:
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _axis_names(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def spec_for(shape: tuple[int, ...], logical: tuple, mesh,
             rules: ShardingRules = ShardingRules()) -> PartitionSpec:
    """A PartitionSpec for `shape` from logical axis names.

    Each dim takes the first rule candidate that (a) exists in the mesh,
    (b) divides the dim size, (c) doesn't reuse a mesh axis already
    assigned to another dim.  Otherwise the dim is replicated, and so is
    a dim of size 1 (a batch of one request), which only an axis of one
    device divides: placing it there would change nothing, and DTensor
    refuses to fold a sharded singleton dim into another.
    """
    assert len(shape) == len(logical), (shape, logical)
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        placed = None
        for cand in rules.get(name) if dim != 1 else ():
            names = _axis_names(cand)
            if any(n not in sizes for n in names):
                continue
            if any(n in used for n in names):
                continue
            if dim % _axis_size(sizes, cand) != 0:
                continue
            placed = cand
            used.update(names)
            break
        out.append(placed)
    return P(*out)


def tree_specs(specs: Mapping[str, tuple], shapes: Mapping[str, Any], mesh,
               rules: ShardingRules = ShardingRules()) -> dict:
    """{name: logical tuple} and {name: shape or tensor} -> {name: spec}."""
    out = {}
    for name, logical in specs.items():
        shaped = shapes[name]
        shape = shaped.shape if hasattr(shaped, "shape") else shaped
        out[name] = spec_for(tuple(shape), tuple(logical), mesh, rules)
    return out


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of `spec` on a `DeviceMesh`: for each mesh dim,
    `Shard(d)` when tensor dim d names that axis (alone or within a
    compound entry), else `Replicate()`."""
    where = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in _axis_names(entry):
            if name in where:
                raise ValueError(f"{spec} uses mesh axis {name!r} twice")
            where[name] = d
    unknown = set(where) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"{spec} names axes {sorted(unknown)} that the mesh "
                         f"{mesh.mesh_dim_names} lacks")
    return tuple(Shard(where[name]) if name in where else Replicate()
                 for name in mesh.mesh_dim_names)


def spec_of(placements_, ndim: int, mesh) -> PartitionSpec:
    """The PartitionSpec of DTensor placements on `mesh` (the inverse of
    `placements`): each tensor dim's Shard axes, in mesh order."""
    entries = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements_):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e)
               for e in entries))


def local_shape(shape: tuple[int, ...], spec: PartitionSpec, mesh
                ) -> tuple[int, ...]:
    """The shard of `shape` one device holds under `spec`."""
    sizes = mesh_sizes(mesh)
    return tuple(dim if entry is None else dim // _axis_size(sizes, entry)
                 for dim, entry in zip(shape, spec))


def shard_index(mesh, entry) -> int:
    """This rank's shard index along a dim sharded on `entry` (an axis
    name, or a tuple of them: pod-major over the flattened submesh)."""
    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for name in _axis_names(entry):
        index = index * sizes[name] + coord[name]
    return index


def contiguous_strides(shape) -> tuple:
    strides, n = [], 1
    for dim in reversed(tuple(shape)):
        strides.append(n)
        n *= dim
    return tuple(reversed(strides))


def from_shard(local, shape, spec: PartitionSpec, mesh):
    """A DTensor of global `shape` laid out by `spec` whose shard on this
    rank is `local` (of `local_shape(shape, spec, mesh)`); no collective
    runs and nothing global is allocated."""
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def shard(tensor, spec: PartitionSpec, mesh):
    """A full tensor (the same on every rank) as a DTensor on `mesh` laid
    out by `spec`: each rank keeps its own slice; no collective runs."""
    sizes = mesh_sizes(mesh)
    local = tensor
    for d, entry in enumerate(spec):
        if entry is not None:
            n = tensor.shape[d] // _axis_size(sizes, entry)
            local = local.narrow(d, shard_index(mesh, entry) * n, n)
    return from_shard(local.contiguous(), tensor.shape, spec, mesh)


def on_shards(fn, mesh, args, in_specs, out_specs):
    """`fn` on each device's shards, through `local_map`: `args` (DTensors,
    or plain tensors standing for replicated ones) are laid out by
    `in_specs` (one `PartitionSpec` each, None for a non-tensor argument)
    and `fn`'s local outputs declared by `out_specs` (a spec, or a tuple
    of specs for several outputs).  The gradient of an input replicated
    on a mesh axis that some input or output is sharded on differs from
    device to device along it: it is declared a partial sum there (a
    replicated gradient would keep one device's part)."""
    in_pl = [None if spec is None else placements(spec, mesh)
             for spec in in_specs]
    single = isinstance(out_specs, PartitionSpec)
    out_pl = [placements(spec, mesh)
              for spec in ((out_specs,) if single else out_specs)]
    varying = {i for pl in [*filter(None, in_pl), *out_pl]
               for i, p in enumerate(pl) if isinstance(p, Shard)}
    grads = tuple(None if pl is None else tuple(
        p if isinstance(p, Shard) else
        (Partial() if i in varying else Replicate())
        for i, p in enumerate(pl)) for pl in in_pl)
    args = [a if pl is None else replicated(a, mesh)
            for a, pl in zip(args, in_pl)]

    def contiguous_fn(*local_args):
        out = fn(*(_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor)
                   and a.requires_grad else a for a in local_args))
        if isinstance(out, torch.Tensor):
            return out.contiguous()
        return tuple(o.contiguous() for o in out)

    return local_map(contiguous_fn, out_placements=(
                         list(out_pl[0]) if single else tuple(out_pl)),
                     in_placements=tuple(in_pl), in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a DTensor's global
    strides say contiguous, so a local gradient laid out otherwise (a
    transpose's, out of a local backward) breaks the `view`s that
    autograd applies to it further back."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def entry_of(t, dim: int):
    """The mesh axes (a name, a tuple of names, or None) DTensor `t`'s
    dim `dim` is sharded on."""
    return spec_of(t.placements, t.ndim, t.device_mesh)[dim]


def nontrivial(entry, mesh):
    """`entry` unless its axes hold one device in all (a shard of the
    whole), else None."""
    if entry is None or _axis_size(mesh_sizes(mesh), entry) == 1:
        return None
    return entry


def free_of(entry, *taken):
    """`entry` if it shares no axis with the `taken` entries, else None."""
    used = {n for e in taken if e is not None for n in _axis_names(e)}
    if entry is None or used & set(_axis_names(entry)):
        return None
    return entry


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------

def make_residual_constraint(mesh, seq_parallel: bool = True,
                             rules: ShardingRules = ShardingRules()):
    """Sharding constraint applied to the (B, S, d) residual stream between
    blocks: batch over DP axes, sequence over "model" (sequence parallel).
    Returns a callable usable as transformer.forward_*(constraint=...):
    a `redistribute` of a DTensor residual to that layout (a plain tensor
    passes through).  The callable carries `rules` as its attribute
    `rules`, which the model's mesh-aware ops read (`rules_of`)."""
    sizes = mesh_sizes(mesh)

    def constrain(x):
        if x.ndim != 3 or not isinstance(x, DTensor):
            return x
        b, s, _ = x.shape
        pb = spec_for((b,), ("batch",), mesh, rules)[0]
        ps = None
        if seq_parallel and s > 1:
            used = () if pb is None else _axis_names(pb)
            cands = [c for c in rules.get("seq")
                     if all(a not in used for a in _axis_names(c))]
            for c in cands:
                if all(a in sizes for a in _axis_names(c)) \
                        and s % _axis_size(sizes, c) == 0:
                    ps = c
                    break
        want = placements(P(pb, ps, None), mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(mesh, want)

    constrain.rules = rules
    return constrain


def batch_specs(batch: Mapping[str, Any], mesh,
                rules: ShardingRules = ShardingRules()) -> dict:
    """Input batch sharding: leading dim = batch, others replicated."""

    def one(x):
        shape = tuple(x.shape)
        if len(shape) == 0:
            return P()
        pb = spec_for((shape[0],), ("batch",), mesh, rules)[0]
        return P(pb, *([None] * (len(shape) - 1)))

    return {k: one(v) for k, v in batch.items()}


def decode_state_spec(shape: tuple[int, ...], mesh) -> PartitionSpec:
    """The PartitionSpec of one `transformer.DecodeState` leaf by its
    shape.  KV caches (L, B, kv, S, hd): batch -> DP, kv-heads -> model
    when divisible else seq -> model (flash-decoding style).  SSM caches
    (L, B, H, N, P): batch -> DP, heads -> model when divisible."""
    nd = len(shape)
    if nd == 0:
        return P()
    if nd == 5:   # (L, B, kv, S, hd) KV cache
        pb = spec_for((shape[1],), ("cache_batch",), mesh)[0]
        ph = spec_for((shape[2],), ("cache_heads",), mesh)[0]
        ps = None
        if ph is None:
            ps = spec_for((shape[3],), ("cache_seq",), mesh)[0]
        return P(None, pb, ph, ps, None)
    if nd == 4:   # (L, B, H, NP) ssm-ish or (B, kv, S, hd) unstacked
        pb = spec_for((shape[1],), ("cache_batch",), mesh)[0]
        ph = spec_for((shape[2],), ("cache_heads",), mesh)[0]
        return P(None, pb, ph, None)
    if nd == 3:   # (B, F, d) encoder output / (L, B, CH) conv cache
        pb = spec_for((shape[0],), ("cache_batch",), mesh)[0]
        return P(pb, None, None)
    if nd == 2:
        pb = spec_for((shape[0],), ("cache_batch",), mesh)[0]
        return P(pb, None)
    return P(*([None] * nd))


def decode_state_specs(state, mesh):
    """`decode_state_spec` over every tensor leaf of a DecodeState (or of
    any NamedTuple / tuple / dict tree of tensors or shapes); empty
    fields stay empty."""
    if isinstance(state, dict):
        return {k: decode_state_specs(v, mesh) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(decode_state_specs(v, mesh) for v in state))
    if isinstance(state, (list, tuple)) and not (
            state and isinstance(state[0], int)):
        return type(state)(decode_state_specs(v, mesh) for v in state)
    shape = tuple(state.shape) if hasattr(state, "shape") else tuple(state)
    return decode_state_spec(shape, mesh)
