"""Step builders: the LM train step, on one device or on a device mesh,
and the sharded train / prefill / decode steps traced for the dry run.

Port of `repro.launch.steps`.  The reference's GSPMD shardings become
DTensor layouts on a `DeviceMesh` (`distributed/sharding.py`):
`train_shardings` / `serve_shardings` give each parameter, moment, batch
and cache leaf its `PartitionSpec`, `shard_params` lays a model's
parameters out by them, and `make_train_step(cfg, opt_cfg, mesh)` runs
the same step body on DTensors (the reference's `jax.jit` with in / out
shardings).  With `mesh=None` the step is the one-device step.  The
reference's `lower_train` / `lower_prefill` / `lower_decode` lower and
compile a step against placeholder devices; their counterparts
`trace_train` / `trace_prefill` / `trace_decode` run one step of the
sharded function on fake tensors under a fake process group and count
what each device would do (`distributed/trace_analysis.py`).
`make_prefill_step` / `make_decode_step` are the serving steps
`serve.server.Server` runs: `models.transformer.forward_prefill` /
`forward_decode`, on a mesh with the parameters and C3 buffers laid out
by `shard_serving_params`.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig
from repro_torch.optim import adamw


def param_shapes_and_specs(cfg: ArchConfig):
    """({name: meta tensor}, {name: logical axes}) of every parameter,
    with nothing allocated."""
    shapes = {name: torch.empty(shape, dtype=dtype, device="meta")
              for name, (shape, dtype) in T.param_shapes(cfg).items()}
    return shapes, T.param_specs(cfg)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def train_shardings(cfg: ArchConfig, mesh, batch: dict,
                    rules: SH.ShardingRules = SH.ShardingRules()):
    """(param specs, AdamW state specs, batch specs, metrics specs), each
    {name: PartitionSpec} (the state's `step` is `P()`)."""
    p_shapes, p_logical = param_shapes_and_specs(cfg)
    p_spec = SH.tree_specs(p_logical, p_shapes, mesh, rules)
    opt_spec = adamw.AdamWState(step=SH.P(), m=p_spec, v=p_spec)
    b_spec = SH.batch_specs(batch, mesh, rules)
    metrics_spec = {"loss": SH.P(), "grad_norm": SH.P(), "lr": SH.P()}
    return p_spec, opt_spec, b_spec, metrics_spec


def shard_params(model: T.Transformer, mesh,
                 rules: SH.ShardingRules = SH.ShardingRules()
                 ) -> T.Transformer:
    """Lay `model`'s parameters (full tensors, the same on every rank) out
    on `mesh` by their `PartitionSpec`s, in place: each becomes a
    DTensor parameter holding this rank's slice.  Returns the model."""
    specs = SH.tree_specs(T.param_specs(model.cfg),
                          dict(model.named_parameters()), mesh, rules)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        setattr(module, leaf, torch.nn.Parameter(
            SH.shard(p.detach(), specs[name], mesh),
            requires_grad=p.requires_grad))
    return model


def shard_batch(batch: dict, mesh,
                rules: SH.ShardingRules = SH.ShardingRules()) -> dict:
    """Each batch tensor (the same on every rank) as a DTensor with its
    leading dim on the batch axes; DTensors pass through."""
    specs = SH.batch_specs(batch, mesh, rules)
    return {k: v if SH.is_dtensor(v) else SH.shard(v, specs[k], mesh)
            for k, v in batch.items()}


def make_train_step(cfg: ArchConfig,
                    opt_cfg: adamw.AdamWConfig | None = None, mesh=None,
                    seq_parallel: bool = True,
                    rules: SH.ShardingRules = SH.ShardingRules()):
    """`train_step(params, opt, batch) -> (params, opt, metrics)`.

    `params` is a `Transformer`, `opt` an `AdamWState` whose moments are
    dicts keyed by the model's parameter names
    (`adamw.init(dict(model.named_parameters()))`).  One step: the loss
    of `forward_train` and its gradients by autograd, then AdamW
    (`adamw.apply_`), which writes the new parameters and moments in
    place; the returned `params` is the same module.  metrics: "loss",
    "grad_norm", "lr" (0-d tensors on the device, not synchronised).

    On a `mesh`, the parameters and moments are DTensors laid out by
    `shard_params` (moments by `adamw.init` of them), the batch is laid
    out by `shard_batch`, the residual by the reference's constraint
    (`make_residual_constraint`, sequence parallel unless
    `seq_parallel=False`), each gradient is brought to its parameter's
    layout before the update, and the metrics are plain tensors.
    """
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if mesh is None:
        def train_step(params: T.Transformer, opt: adamw.AdamWState,
                       batch: dict):
            named = dict(params.named_parameters())
            loss = T.forward_train(params, cfg, batch)
            grads = dict(zip(named, torch.autograd.grad(
                loss, list(named.values()))))
            opt, metrics = adamw.apply_(opt_cfg, grads, opt, named)
            return params, opt, {"loss": loss.detach(), **metrics}

        return train_step

    from torch.distributed.tensor.experimental import implicit_replication

    constraint = SH.make_residual_constraint(mesh, seq_parallel, rules)

    def sharded_step(params: T.Transformer, opt: adamw.AdamWState,
                     batch: dict):
        named = dict(params.named_parameters())
        with implicit_replication():
            loss = T.forward_train(params, cfg, shard_batch(batch, mesh,
                                                            rules),
                                   constraint)
            grads = torch.autograd.grad(loss, list(named.values()))
            grads = {n: g if tuple(g.placements) == tuple(p.placements)
                     else g.redistribute(mesh, p.placements)
                     for (n, p), g in zip(named.items(), grads)}
            opt, metrics = adamw.apply_(opt_cfg, grads, opt, named)
        metrics = {k: SH.full(v) for k, v in metrics.items()}
        return params, opt, {"loss": SH.full(loss.detach()), **metrics}

    return sharded_step


# ---------------------------------------------------------------------------
# Serve: prefill / decode
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ArchConfig, mesh, cache_len: int,
                      seq_parallel: bool = True,
                      rules: SH.ShardingRules = SH.ShardingRules()):
    """`prefill_step(params, batch) -> (last-token logits, DecodeState)`.

    With `mesh=None`, `forward_prefill` on one device.  On a mesh the
    parameters are laid out by `shard_serving_params`, the batch by
    `shard_batch` (the prompts on the batch axes), the residual by the
    reference's constraint (sequence parallel unless
    `seq_parallel=False`) under `rules`; the caches come out laid out by
    `decode_state_specs` and the logits as a DTensor.  As the
    reference's, the step takes no C3 parameter transform (the server
    builds its C3 prefill itself)."""
    if mesh is None:
        def prefill_step(params: T.Transformer, batch: dict):
            return T.forward_prefill(params, cfg, batch, cache_len)

        return prefill_step
    constraint = SH.make_residual_constraint(mesh, seq_parallel, rules)

    def sharded_prefill(params: T.Transformer, batch: dict):
        logits, state = _serve_call(T.forward_prefill, params, cfg,
                                    shard_batch(batch, mesh, rules),
                                    cache_len,
                                    constraint=constraint)
        return logits, lay_out_state(state, mesh)

    return sharded_prefill


def lay_out_state(state: T.DecodeState, mesh) -> T.DecodeState:
    """A prefill's DecodeState with every leaf laid out by
    `decode_state_specs`: the caches are made so; the audio family's
    encoder output, as its last layer left it, is redistributed."""
    enc = state.enc_out
    if not SH.is_dtensor(enc):
        return state
    want = SH.placements(SH.decode_state_spec(tuple(enc.shape), mesh), mesh)
    if tuple(enc.placements) == want:
        return state
    return state._replace(enc_out=enc.redistribute(mesh, want))


def make_decode_step(cfg: ArchConfig, mesh,
                     rules: SH.ShardingRules = SH.ShardingRules()):
    """`decode_step(params, state, tokens) -> (logits, DecodeState)`: one
    `forward_decode` step; under `cfg.quant_serving` through
    `quant.lm_quant.make_param_transform(cfg.dtype)`.  On a mesh the
    tokens (B, 1) go on the batch axes and the residual is constrained
    without sequence parallelism, under `rules`; with `mesh=None` the
    one-device step."""
    pt = None
    if cfg.quant_serving:
        from repro_torch.quant.lm_quant import make_param_transform

        pt = make_param_transform(cfg.dtype)
    if mesh is None:
        def decode_step(params: T.Transformer, state: T.DecodeState,
                        tokens: torch.Tensor):
            return T.forward_decode(params, cfg, state, tokens,
                                    param_transform=pt)

        return decode_step
    constraint = SH.make_residual_constraint(mesh, seq_parallel=False,
                                             rules=rules)

    def sharded_decode(params: T.Transformer, state: T.DecodeState,
                       tokens: torch.Tensor):
        tokens = shard_batch({"tokens": tokens}, mesh, rules)["tokens"]
        return _serve_call(T.forward_decode, params, cfg, state, tokens,
                           param_transform=pt, constraint=constraint)

    return sharded_decode


# ---------------------------------------------------------------------------
# Serve: the parameter and cache layouts
# ---------------------------------------------------------------------------

def serving_param_specs(model: T.Transformer, mesh,
                        rules: SH.ShardingRules = SH.ShardingRules()
                        ) -> dict:
    """{name: PartitionSpec} of every parameter and C3 buffer of `model`
    (`named_parameters` and `named_buffers` names): `serve_shardings`'s
    rule on the model's own leaves.  A quantized leaf's `idx` / `idx4`
    takes its weight's logical axes and its codebook `cb` is replicated,
    so a model quantized at some layers only is laid out too."""
    logical = T.param_specs(model.cfg)
    leaves = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    axes = {}
    for name in leaves:
        weight, _, key = name.rpartition(".")
        axes[name] = (logical[name] if name in logical else
                      (None,) if key == "cb" else logical[weight])
    return SH.tree_specs(axes, leaves, mesh, rules)


def shard_serving_params(model: T.Transformer, mesh,
                         rules: SH.ShardingRules = SH.ShardingRules()
                         ) -> T.Transformer:
    """Lay `model`'s parameters and C3 buffers (full tensors, the same on
    every rank) out on `mesh` by `serving_param_specs`, in place, as
    `shard_params` lays out the parameters; DTensors stay as they are.
    Returns the model."""
    specs = serving_param_specs(model, mesh, rules)
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        if SH.is_dtensor(t):
            continue
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        laid = SH.shard(t.detach(), specs[name], mesh)
        if isinstance(t, torch.nn.Parameter):
            laid = torch.nn.Parameter(laid, requires_grad=t.requires_grad)
        setattr(module, leaf, laid)
    return model


def _quantize_param_structs(cfg: ArchConfig, shapes: dict, logical: dict,
                            pack_4bit: bool = False):
    """quant_serving (C3): each quantizable block weight becomes its
    index tensor (`name.idx` int8, or `name.idx4` two 4-bit indexes a
    byte) and its codebook (`name.cb`, 16 f32) in the argument
    structure — decode reads 1 byte (int8) or half a byte (4-bit) a
    weight instead of 2 (bf16).  The index keeps the weight's logical
    axes; the codebook is replicated."""
    from repro_torch.quant.lm_quant import _quantizable

    qshapes, qspecs = {}, {}
    for name, leaf in shapes.items():
        parts = name.split(".")
        if parts[0] == "blocks" and _quantizable(parts[2], leaf,
                                                 cfg.n_layers):
            cb = f"{name}.cb"
            qshapes[cb] = torch.empty((16,), dtype=torch.float32,
                                      device="meta")
            qspecs[cb] = (None,)
            if pack_4bit and leaf.shape[-1] % 2 == 0:
                packed = tuple(leaf.shape[:-1]) + (leaf.shape[-1] // 2,)
                qshapes[f"{name}.idx4"] = torch.empty(
                    packed, dtype=torch.uint8, device="meta")
                qspecs[f"{name}.idx4"] = logical[name]
            else:
                qshapes[f"{name}.idx"] = torch.empty(
                    tuple(leaf.shape), dtype=torch.int8, device="meta")
                qspecs[f"{name}.idx"] = logical[name]
        else:
            qshapes[name] = leaf
            qspecs[name] = logical[name]
    return qshapes, qspecs


def serve_shardings(cfg: ArchConfig, mesh, batch: int, cache_len: int):
    """(param shapes, param specs, cache shapes, cache specs, logits
    spec) of serving `batch` rows with caches of `cache_len` (quantized
    structures under `cfg.quant_serving`)."""
    p_shapes, p_logical = param_shapes_and_specs(cfg)
    if cfg.quant_serving:
        p_shapes, p_logical = _quantize_param_structs(
            cfg, p_shapes, p_logical,
            pack_4bit=(cfg.quant_serving == "4bit"))
    p_spec = SH.tree_specs(p_logical, p_shapes, mesh)
    state_shapes = T.init_decode_state(cfg, batch, cache_len, device="meta")
    state_spec = SH.decode_state_specs(state_shapes, mesh)
    pb = SH.spec_for((batch,), ("batch",), mesh)[0]
    pv = SH.spec_for((batch, cfg.vocab), ("batch", "vocab"), mesh)
    logits_spec = SH.P(pb, pv[1])
    return p_shapes, p_spec, state_shapes, state_spec, logits_spec


# ---------------------------------------------------------------------------
# Traced steps (the dry run): one step on fake tensors
# ---------------------------------------------------------------------------

def _fake_dtensor(shape, dtype, spec, mesh):
    """A DTensor of global `shape` laid out by `spec`, its local shard an
    empty tensor of the active (fake) mode."""
    return SH.from_shard(torch.empty(SH.local_shape(shape, spec, mesh),
                                     dtype=dtype), shape, spec, mesh)


def _fake_model(cfg: ArchConfig, mesh, rules: SH.ShardingRules):
    """The model with DTensor parameters of empty (fake) local shards."""
    shapes = T.param_shapes(cfg)
    specs = SH.tree_specs(T.param_specs(cfg),
                          {n: s for n, (s, _) in shapes.items()}, mesh, rules)
    return T.model_from(cfg, {
        name: _fake_dtensor(shape, dtype, specs[name], mesh)
        for name, (shape, dtype) in shapes.items()})


def _local_bytes(tensors) -> int:
    total = 0
    for t in tensors:
        if SH.is_dtensor(t):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def _fake_batch(batch: dict, mesh, rules) -> dict:
    specs = SH.batch_specs(batch, mesh, rules)
    return {k: _fake_dtensor(tuple(v.shape), v.dtype, specs[k], mesh)
            for k, v in batch.items()}


@contextlib.contextmanager
def _fake_mode():
    """Tensors made inside are fake: shapes and types, no memory.  The
    step itself runs outside the mode, on those fake tensors (their ops
    stay fake), so DTensor's own small host tensors stay real."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        yield mode


def trace_train(cfg: ArchConfig, mesh, batch: dict,
                opt_cfg: adamw.AdamWConfig | None = None,
                seq_parallel: bool = True,
                rules: SH.ShardingRules = SH.ShardingRules(),
                match_elems: int | None = None):
    """One sharded train step on fake tensors over `mesh` (a fake world):
    `batch` holds meta tensors of the cell's shapes.  Returns
    (`trace_analysis.TraceCosts` of one device, argument bytes: the local
    parameters, moments and batch)."""
    from repro_torch.distributed import trace_analysis as TA

    with _fake_mode() as fake:
        model = _fake_model(cfg, mesh, rules)
        named = dict(model.named_parameters())
        opt = adamw.init(named)
        fb = _fake_batch(batch, mesh, rules)
    arg_bytes = _local_bytes([*named.values(), *opt.m.values(),
                              *opt.v.values(), *fb.values()])
    step = make_train_step(cfg, opt_cfg, mesh, seq_parallel, rules)
    costs = TA.trace(lambda: step(model, opt, fb), match_elems=match_elems,
                     fake_mode=fake)
    return costs, arg_bytes


def _fake_serving_model(cfg: ArchConfig, mesh):
    """The served model on fake shards; with `cfg.quant_serving`, its
    block weights as C3 index / codebook leaves."""
    if not cfg.quant_serving:
        return _fake_model(cfg, mesh, SH.ShardingRules()), None
    from repro_torch.quant.lm_quant import make_param_transform

    shapes, logical = _quantize_param_structs(
        cfg, *param_shapes_and_specs(cfg),
        pack_4bit=(cfg.quant_serving == "4bit"))
    specs = SH.tree_specs(logical, shapes, mesh)
    leaves = {n: _fake_dtensor(tuple(t.shape), t.dtype, specs[n], mesh)
              for n, t in shapes.items()}
    tensors = {n: t for n, t in leaves.items()
               if not n.endswith((".idx", ".idx4", ".cb"))}
    for n, t in leaves.items():
        if n.endswith((".idx", ".idx4", ".cb")):
            weight, key = n.rsplit(".", 1)
            tensors.setdefault(weight, {})[key] = t
    return T.model_from(cfg, tensors), make_param_transform(cfg.dtype)


def trace_prefill(cfg: ArchConfig, mesh, batch: dict, cache_len: int,
                  seq_parallel: bool = True, match_elems: int | None = None):
    """One sharded prefill on fake tensors; (costs, argument bytes: the
    local parameters and batch)."""
    from repro_torch.distributed import trace_analysis as TA

    constraint = SH.make_residual_constraint(mesh, seq_parallel)
    with _fake_mode() as fake:
        model, pt = _fake_serving_model(cfg, mesh)
        fb = _fake_batch(batch, mesh, SH.ShardingRules())
    arg_bytes = _local_bytes([*model.parameters(), *model.buffers(),
                              *fb.values()])
    costs = TA.trace(lambda: _serve_call(
        T.forward_prefill, model, cfg, fb, cache_len, param_transform=pt,
        constraint=constraint), match_elems=match_elems, fake_mode=fake)
    return costs, arg_bytes


def trace_decode(cfg: ArchConfig, mesh, batch: int, cache_len: int,
                 match_elems: int | None = None):
    """One sharded decode step on fake tensors, the caches laid out by
    `decode_state_spec`; (costs, argument bytes: the local parameters,
    caches and tokens)."""
    from repro_torch.distributed import trace_analysis as TA

    constraint = SH.make_residual_constraint(mesh, seq_parallel=False)
    with _fake_mode() as fake:
        model, pt = _fake_serving_model(cfg, mesh)
        state = T.init_decode_state(cfg, batch, cache_len, device="cpu",
                                    mesh=mesh)
        tokens = _fake_dtensor((batch, 1), torch.int32,
                               SH.batch_specs({"t": torch.empty(batch, 1)},
                                              mesh)["t"], mesh)
    leaves = [t for t in adamw.tree_leaves(state)
              if isinstance(t, torch.Tensor)]
    arg_bytes = _local_bytes([*model.parameters(), *model.buffers(),
                              *leaves, tokens])
    costs = TA.trace(lambda: _serve_call(
        T.forward_decode, model, cfg, state, tokens, param_transform=pt,
        constraint=constraint), match_elems=match_elems, fake_mode=fake)
    return costs, arg_bytes


def _serve_call(fn, *args, **kw):
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        return fn(*args, **kw)
