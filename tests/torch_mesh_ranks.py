"""Rank programs of tests/test_torch_mesh_train.py and
tests/test_torch_mesh_serve.py: gloo ranks spawned on the CPU, each
training or serving the port's LM on a ("data", "model") DeviceMesh
(`launch/mesh.py` `make_host_mesh`) from weights and batches the test
hands over, and saving what it saw.  Imports no JAX, so a rank starts in
a few seconds.

`spawn_mesh_ranks` starts the ranks, joins them by a deadline, stops any
that is still alive and fails unless every rank exited 0.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

GROUP_TIMEOUT = timedelta(seconds=60)
JOIN_DEADLINE_S = 240


def spawn_mesh_ranks(tmp_path: Path, world: int, model: int,
                     cases: list[dict], device: str = "cpu") -> list:
    """Run `cases` on `world` gloo ranks meshed (world // model, model) on
    `device` (the CPU, or "cuda:0": every rank on the one card); returns
    each rank's results (a list of per-case dicts)."""
    torch.save(cases, tmp_path / "cases.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, model, str(tmp_path), device))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert not hung and codes == [0] * world, (
        f"ranks hung {hung}, exit codes {codes}")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def rank_main(rank: int, world: int, model: int, tmp: str,
              device: str = "cpu") -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(model=model, device=device)
        cases = torch.load(f"{tmp}/cases.pt", weights_only=False)
        torch.save([run_case(c, mesh) for c in cases], f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_case(case: dict, mesh) -> dict:
    """case: "kind" "train" (arch, params: {name: tensor}, batches, opt;
    the SMOKE config in f32 unless "smoke" is False, fields replaced by
    "cfg"),
    "checkpoint" (save at this world, or restore), "decode" (arch,
    params, prompt batch, cache_len, steps) or "server" (arch, params,
    prompts, slots, cache_len, new; on a mesh of "model" ranks a data
    group when given, else the ranks' own), "moe_flops" (arch, params,
    slots), "vocab_loss" (logits, labels), "seq_pieces" (inputs of the
    sequence-split attention, conv, scan and mamba2 layer), "seq_flops"
    (a mamba2 layer and an attention traced on one device and on the
    mesh), "ssm_decode_flops" (a mamba2 decode step's products),
    "hybrid_layer" (a zamba2 layer's meshed prefill) or
    "embed_routes" (the vocab-parallel lookup's two routes)."""
    return {"train": _train, "decode": _serve, "server": _server,
            "checkpoint": _checkpoint, "moe_flops": _moe_flops,
            "vocab_loss": _vocab_loss, "seq_pieces": _seq_pieces,
            "seq_flops": _seq_flops, "ssm_decode_flops": _ssm_decode_flops,
            "hybrid_layer": _hybrid_layer,
            "embed_routes": _embed_routes}[case["kind"]](case, mesh)


def _cfg(case):
    from repro_torch.configs import registry as R

    return dataclasses.replace(
        R.get_arch(case["arch"], smoke=case.get("smoke", True)),
        dtype=torch.float32, **case.get("cfg", {}))


def _model(cfg, params, mesh):
    """The model of `params` ({name: tensor}, a C3 leaf {"idx" | "idx4",
    "cb"} under its weight's name) on the mesh's device."""
    from repro_torch.models import transformer as T

    dev = torch.device(mesh.device_type)

    def to(v):
        if isinstance(v, dict):
            return {k: t.to(dev, copy=True) for k, t in v.items()}
        return v.to(dev, copy=True)

    return T.model_from(cfg, {k: to(v) for k, v in params.items()})


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _train(case, mesh) -> dict:
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw

    cfg = _cfg(case)
    rules = SH.ShardingRules(SH.FSDP_RULES if case.get("fsdp") else None)
    model = ST.shard_params(_model(cfg, case["params"], mesh), mesh, rules)
    opt = adamw.init(dict(model.named_parameters()))
    step = ST.make_train_step(cfg, adamw.AdamWConfig(**case["opt"]), mesh,
                              seq_parallel=case.get("seq_parallel", True),
                              rules=rules)
    losses, norms = [], []
    dev = torch.device(mesh.device_type)
    for batch in case["batches"]:
        model, opt, m = step(model, opt, {k: v.to(dev)
                                          for k, v in batch.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    placements = {n: tuple(f"Shard({p.dim})" if p.is_shard() else
                           type(p).__name__ for p in t.placements)
                  for n, t in model.named_parameters()}
    out = {"loss": losses, "grad_norm": norms, "placements": placements}
    if case.get("return_params"):
        out["params"] = {n: _full(t).detach()
                         for n, t in model.named_parameters()}
    return out


def _serve(case, mesh) -> dict:
    """Prefill then `steps` greedy decode steps on the mesh; the logits
    of each step as full tensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    cfg = _cfg(case)
    model = ST.shard_params(_model(cfg, case["params"], mesh), mesh)
    prefill_c = SH.make_residual_constraint(mesh, True)
    decode_c = SH.make_residual_constraint(mesh, seq_parallel=False)
    logits = []
    with implicit_replication():
        batch = ST.shard_batch(case["batch"], mesh)
        out, state = T.forward_prefill(model, cfg, batch, case["cache_len"],
                                       constraint=prefill_c)
        logits.append(_full(out))
        tok = case["batch"]["tokens"][:, -1:]
        for _ in range(case["steps"]):
            tok = logits[-1].argmax(-1, keepdim=True).to(torch.int32)
            out, state = T.forward_decode(
                model, cfg, state, ST.shard_batch({"t": tok}, mesh)["t"],
                constraint=decode_c)
            logits.append(_full(out))
    return {"logits": logits}


def _server(case, mesh) -> dict:
    """`Server(mesh=...)` over the case's prompts (under the case's
    sharding "rules", the defaults without): each request's tokens,
    the full logits `sample` got at every step, the operand shapes of
    every codebook product (and whether one was a DTensor), whether the parameters
    and C3 buffers lie as `serving_param_specs` says, and the first
    prefill's state leaves' specs beside `decode_state_spec`'s."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve.server import Request, Server

    if case.get("model", mesh.size(1)) != mesh.size(1):
        mesh = make_host_mesh(model=case["model"], device=mesh.device_type)
    cfg = _cfg(case)
    model = _model(cfg, case["params"], mesh)
    rules = SH.ShardingRules(case.get("rules"))
    srv = Server(cfg, model, batch_slots=case["slots"],
                 cache_len=case["cache_len"], mesh=mesh, rules=rules)
    states = []
    prefill = srv.prefill

    def kept(params, batch):
        out = prefill(params, batch=batch)
        states.append(out[1])
        return out

    srv.prefill = kept
    for uid, prompt in enumerate(case["prompts"]):
        srv.submit(Request(uid=uid, prompt=prompt,
                           max_new_tokens=case["new"]))
    logits = []

    def sample(lg):
        assert not SH.is_dtensor(lg)
        logits.append(lg.clone())
        return lg.argmax(-1)

    from repro_torch.kernels import codebook_matmul as CBM

    kernel, products = CBM.codebook_matmul, []

    def counted(x, idx, cb):
        products.append((tuple(x.shape), tuple(idx.shape),
                         SH.is_dtensor(x) or SH.is_dtensor(idx)))
        return kernel(x, idx, cb)

    CBM.codebook_matmul = counted
    try:
        done = srv.run(sample=sample)
    finally:
        CBM.codebook_matmul = kernel
    specs = ST.serving_param_specs(srv.params, mesh, rules)
    laid = {n: SH.spec_of(t.placements, t.ndim, mesh) == specs[n]
            for n, t in [*srv.params.named_parameters(),
                         *srv.params.named_buffers()]}
    leaves = tree_leaves(states[0])
    want = [SH.decode_state_spec(tuple(t.shape), mesh) for t in leaves]
    got = [SH.spec_of(t.placements, t.ndim, mesh) if SH.is_dtensor(t)
           else SH.P(*[None] * t.ndim) for t in leaves]
    return {"tokens": [r.out_tokens for r in done], "logits": logits,
            "codebook_products": products,
            "params_laid_out": all(laid.values()) and len(laid) > 0,
            "buffers": sorted(n for n, _ in srv.params.named_buffers()),
            "state_specs": got, "state_specs_want": want}


def _moe_flops(case, mesh) -> dict:
    """The first moe layer of a decode step, its `slots` rows (B, 1, d)
    drawn from a seeded gaussian, traced (`trace_analysis.trace`) on one
    device and on a data 2 x model 1 mesh of the ranks (the rows on
    "data": the decode group straddles the two batch shards): the FLOPs
    of each, the FLOPs of the router product alone, and both outputs."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import trace_analysis as TA
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import linear
    from repro_torch.models.moe import moe_ffn

    mesh = make_host_mesh(model=1, device=mesh.device_type)
    cfg = _cfg(case)
    model = _model(cfg, case["params"], mesh)
    x = torch.randn(case["slots"], 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    layer = model.blocks[0]
    router = TA.trace(lambda: linear(x.reshape(1, -1, cfg.d_model),
                                     layer["router"])).flops
    one = TA.trace(lambda: moe_ffn(x, layer, cfg))
    with torch.no_grad():
        want = moe_ffn(x, layer, cfg)[0]
    ST.shard_serving_params(model, mesh)
    xs = ST.shard_batch({"x": x}, mesh)["x"]
    with implicit_replication(), torch.no_grad():
        meshed = TA.trace(lambda: moe_ffn(xs, model.blocks[0], cfg))
        got = _full(moe_ffn(xs, model.blocks[0], cfg)[0])
    return {"router": router, "one": one.flops, "mesh": meshed.flops,
            "per_kind": meshed.op_counts, "want": want, "got": got,
            "stacks": {k: tuple(model.blocks[0][k].to_local().shape)
                       for k in ("moe_wi", "moe_wg", "moe_wo")}}


def _vocab_loss(case, mesh) -> dict:
    """`cross_entropy_loss` of the case's logits (B, S, V), replicated on
    the mesh, and its gradient: the loss, the full gradient, and the
    layout and local vocab width the loss put the logits in."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.models import common as C

    logits = SH.shard(case["logits"], SH.P(None, None, None), mesh)
    logits.requires_grad_(True)
    labels = SH.shard(case["labels"], SH.P(None, None), mesh)
    with implicit_replication():
        laid, split = C._vocab_layout(logits, SH.ShardingRules())
        loss = C.cross_entropy_loss(logits, labels)
        loss.backward()
    return {"loss": float(_full(loss)), "grad": _full(logits.grad),
            "split": split, "local_vocab": laid.to_local().shape[-1],
            "placements": [repr(p) for p in laid.placements]}


def _checkpoint(case, mesh) -> dict:
    """Train `steps` steps with `Trainer(mesh=...)` from the seed, or
    restore the latest checkpoint of `ckpt_dir` onto this mesh."""
    from repro_torch.train.trainer import Trainer, TrainJobConfig

    cfg = _cfg(case)
    job = TrainJobConfig(batch=case["batch"], seq_len=case["seq"],
                         num_steps=case["steps"], save_every=case["steps"],
                         ckpt_dir=case["ckpt_dir"], seed=case["seed"])
    tr = Trainer(cfg, job, mesh=mesh, device="cpu")
    losses = []
    state = tr.run(on_metrics=lambda s, m, dt: losses.append(
        float(m["loss"])))
    return {"loss": losses,
            "params": {n: _full(t).detach()
                       for n, t in state["params"].named_parameters()},
            "step": int(state["opt"].step)}


def _seq_split(t, mesh, dims: int):
    """Full tensor `t` as a DTensor split on "model" along dim 1 (the
    sequence) when `dims` says so, else replicated; a leaf that wants its
    gradient."""
    from repro_torch.distributed import sharding as SH

    spec = SH.P(None, "model" if dims else None, *[None] * (t.ndim - 2))
    return SH.shard(t, spec, mesh).requires_grad_(True)


def _run_piece(fn, inputs: dict, split: dict, cotangents, mesh) -> dict:
    """`fn(**DTensor inputs)` on the mesh: the full outputs, each output's
    placements, and the full gradients of every input under the given
    cotangents (one per output)."""
    from torch.distributed.tensor.experimental import implicit_replication

    args = {k: _seq_split(v, mesh, split.get(k, 0)) for k, v in inputs.items()}
    with implicit_replication():
        outs = fn(**args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads = torch.autograd.grad(
            outs, list(args.values()),
            [_seq_split(g, mesh, 0).detach().redistribute(
                o.device_mesh, o.placements) for g, o in zip(cotangents,
                                                               outs)])
    return {"out": [_full(o).detach() for o in outs],
            "placements": [tuple(repr(p) for p in o.placements)
                           for o in outs],
            "grads": {k: _full(g) for k, g in zip(args, grads)}}


def _seq_pieces(case, mesh) -> dict:
    """The sequence-split pieces on the mesh, each from the case's full
    inputs: causal attention (plain and query-chunked), full attention,
    the causal conv with its halo, the SSD scan by chunks and a whole
    mamba2 layer with its prefill cache (its parameters plain tensors,
    replicated)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import attention as A
    from repro_torch.models import mamba2 as M

    rules = SH.ShardingRules()
    acfg = _cfg({"arch": "whisper-tiny"})
    chunked = dataclasses.replace(acfg, attn_chunk=case["attn_chunk"])
    mcfg = _cfg({"arch": "mamba2-130m"})
    _, _, _, hp = M.dims(mcfg)
    att, ssm = case["attention"], case["ssm"]
    qkv = {k: att[k] for k in ("q", "k", "v")}
    out = {
        "causal": _run_piece(
            lambda q, k, v: A._self_attention(q, k, v, acfg, rules), qkv,
            {"q": 1, "k": 1, "v": 1}, [att["g"]], mesh),
        "chunked": _run_piece(
            lambda q, k, v: A._self_attention(q, k, v, chunked, rules), qkv,
            {"q": 1, "k": 1, "v": 1}, [att["g"]], mesh),
        "full": _run_piece(
            lambda q, k, v: A._full_attention(q, k, v, acfg, rules),
            {"q": att["q"], "k": att["ek"], "v": att["ev"]}, {"q": 1},
            [att["g"]], mesh),
        "conv": _run_piece(
            lambda xbc, conv_w, conv_b: M._causal_conv_train(
                xbc, conv_w, conv_b, rules),
            {k: ssm[k] for k in ("xbc", "conv_w", "conv_b")}, {"xbc": 1},
            [ssm["g_conv"]], mesh),
        "scan": _run_piece(
            lambda xin, dt, B, C, A_log, dt_bias, D: M._scan_on_shards(
                rules, hp, mcfg.ssm_chunk, xin, dt, B, C, A_log, dt_bias, D),
            {k: ssm[k] for k in ("xin", "dt", "B", "C", "A_log", "dt_bias",
                                 "D")},
            {"xin": 1, "dt": 1, "B": 1, "C": 1},
            [ssm["g_scan"], ssm["g_state"]], mesh),
        "layer": _run_piece(
            lambda x, **p: M.mamba2_forward(x, p, mcfg, return_cache=True,
                                            rules=rules)[0],
            {"x": ssm["x"], **ssm["params"]}, {"x": 1}, [ssm["g_layer"]],
            mesh),
    }
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication(), torch.no_grad():
        x = _seq_split(ssm["x"], mesh, 1)
        _, cache = M.mamba2_forward(x, ssm["params"], mcfg,
                                    return_cache=True, rules=rules)
    out["cache"] = {"conv": _full(cache.conv), "state": _full(cache.state)}
    return out


def _seq_flops(case, mesh) -> dict:
    """A mamba2 layer's forward and a causal self-attention traced
    (`trace_analysis.trace`) on one device and, the sequence split, on the
    mesh: FLOPs a device and the largest all-gather output of each."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import trace_analysis as TA
    from repro_torch.models import attention as A
    from repro_torch.models import mamba2 as M

    rules = SH.ShardingRules()
    acfg, mcfg = _cfg({"arch": "whisper-tiny"}), _cfg({"arch": "mamba2-130m"})
    att, ssm = case["attention"], case["ssm"]
    runs = {"layer": lambda x: M.mamba2_forward(x["x"], ssm["params"], mcfg,
                                                rules=rules),
            "attention": lambda x: A._self_attention(x["q"], x["k"], x["v"],
                                                     acfg, rules)}
    inputs = {"layer": {"x": ssm["x"]},
              "attention": {k: att[k] for k in ("q", "k", "v")}}
    out = {}
    with torch.no_grad():
        for name, run in runs.items():
            one = TA.trace(lambda: run(inputs[name]))
            with implicit_replication():
                split = {k: _seq_split(v, mesh, 1).detach()
                         for k, v in inputs[name].items()}
                meshed = TA.trace(lambda: run(split))
            out[name] = {"one": one.flops, "mesh": meshed.flops,
                         "gathered": meshed.largest.get("all-gather", 0)}
    return out


def _ssm_decode_flops(case, mesh) -> dict:
    """A mamba2 decode step's three products, on one device and on the
    mesh (the serving layout, `shard_serving_params`; its rows (B, 1, d)
    from a seeded gaussian on the batch axes), each traced
    (`trace_analysis.trace`): in_proj (`mamba2._in_proj`), out_proj on
    the meshed z (B, 1, d_in) as its input (`_rows_as`) and the logits
    (`transformer._logits`).  For each: the FLOPs of one device and of
    this rank, and both outputs (full)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import trace_analysis as TA
    from repro_torch.launch import steps as ST
    from repro_torch.models import mamba2 as M
    from repro_torch.models import transformer as T
    from repro_torch.models.common import linear

    rules = SH.ShardingRules()
    cfg = _cfg(case)
    one = _model(cfg, case["params"], mesh)
    model = ST.shard_serving_params(_model(cfg, case["params"], mesh), mesh)
    x = torch.randn(case["slots"], 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    xs = ST.shard_batch({"x": x}, mesh)["x"]
    p1, pm = one.blocks[0], model.blocks[0]
    out = {}
    with implicit_replication(), torch.no_grad():
        axes = ("model",)
        z1 = M._in_proj(x, p1["in_proj"], cfg, axes)[0]
        zm = M._in_proj(xs, pm["in_proj"], cfg, axes)[0]
        runs = {
            "in_proj": (lambda: M._in_proj(x, p1["in_proj"], cfg, axes),
                        lambda: M._in_proj(xs, pm["in_proj"], cfg, axes)),
            "out_proj": (lambda: linear(z1, p1["out_proj"]),
                         lambda: linear(zm, M._rows_as(pm["out_proj"], zm))),
            "logits": (lambda: T._logits(one, cfg, x, rules),
                       lambda: T._logits(model, cfg, xs, rules))}
        for name, (f1, fm) in runs.items():
            a, b = f1(), fm()
            a, b = (a, b) if name != "in_proj" else (
                torch.cat(a, -1), torch.cat([_full(t) for t in b], -1))
            out[name] = {"one": TA.trace(f1).flops, "mesh": TA.trace(fm).flops,
                         "want": a, "got": _full(b)}
    return out


def _hybrid_layer(case, mesh) -> dict:
    """A zamba2 layer's prefill (block 0 of the case's params, laid out by
    `shard_params`: its heads on "model") on the mesh, its input (B, S,
    d) and output laid out as the residual is (the batch on its axes, the
    sequence on "model"): the output and the cache (the raw conv window
    and the SSM state; full), and the forward's largest all-gather
    (`trace_analysis.trace`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import trace_analysis as TA
    from repro_torch.launch import steps as ST
    from repro_torch.models import mamba2 as M

    rules = SH.ShardingRules()
    cfg = _cfg(case)
    model = ST.shard_params(_model(cfg, case["params"], mesh), mesh)
    lp = model.blocks[0]
    residual = SH.make_residual_constraint(mesh, True)

    def prefill():
        return M.mamba2_forward(x, lp, cfg, return_cache=True, rules=rules)

    with implicit_replication(), torch.no_grad():
        x = residual(SH.replicated(case["x"].to(mesh.device_type), mesh))
        costs = TA.trace(prefill)
        y, cache = prefill()
        y = residual(y)
    return {"out": _full(y), "conv": _full(cache.conv),
            "state": _full(cache.state),
            "largest_gather": costs.largest["all-gather"]}


def _embed_routes(case, mesh) -> dict:
    """The vocab-parallel lookup (`transformer.embed_tokens`) of each of
    the case's token batches (the batch on its axes) in the model's
    table, laid out by `shard_params` (vocab on "model", d on "data"):
    the rows and the table's gradient under sum(rows ** 2) (full), and
    the largest all-gather of the lookup (`trace_analysis.trace`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import trace_analysis as TA
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    cfg = _cfg(case)
    model = ST.shard_params(_model(cfg, case["params"], mesh), mesh)
    out = []
    with implicit_replication():
        for tokens in case["tokens"]:
            t = ST.shard_batch({"t": tokens}, mesh)["t"]
            with torch.no_grad():
                costs = TA.trace(lambda: T.embed_tokens(model, cfg, t))
            rows = T.embed_tokens(model, cfg, t)
            (grad,) = torch.autograd.grad(rows.square().sum(), model.embed)
            out.append({"rows": _full(rows).detach(), "grad": _full(grad),
                        "largest_gather": costs.largest["all-gather"]})
    return out
