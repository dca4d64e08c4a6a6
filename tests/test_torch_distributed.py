"""The port's distributed modules against the JAX package, on the CPU.

* `distributed.sharding`: `spec_for` and `decode_state_specs` on the
  reference's own cases, and every parameter's spec against the
  reference's (its stacked "layers" entry dropped) for all ten
  architectures on (16, 16) and (2, 16, 16), names matched through
  `convert`'s layout;
* `distributed.compression`: payload, scale and residual bitwise the
  reference's on seeded inputs, error feedback, compressed training;
* `distributed.collectives`: `comparison()` rows and
  `hierarchical_all_reduce` equal to the reference's;
* `distributed.roofline.model_flops_for` for every arch x shape,
  `ElasticPlan.plan`, the registry's `cell_is_runnable` /
  `runnable_cells` / `input_specs`;
* `distributed.trace_analysis`: FLOPs of a matmul loop, per-device FLOPs
  of a sharded product on a fake 16-rank world (in a subprocess), the
  cost of a one-row cache write.

Exact equality throughout; the compression payloads bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.convert import _lm_slot
from repro_torch.distributed import collectives as TCOL
from repro_torch.distributed import compression as TCOMP
from repro_torch.distributed import roofline as TRL
from repro_torch.distributed import sharding as TSH
from repro_torch.distributed import trace_analysis as TA
from repro_torch.distributed.elastic import ElasticPlan as TElasticPlan
from repro_torch.models import transformer as TT

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as RR  # noqa: E402
from repro.distributed import collectives as RCOL  # noqa: E402
from repro.distributed import compression as RCOMP  # noqa: E402
from repro.distributed import roofline as RRL  # noqa: E402
from repro.distributed import sharding as RSH  # noqa: E402
from repro.distributed.elastic import ElasticPlan as RElasticPlan  # noqa: E402
from repro.launch import steps as RST  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """The reference's spec_for reads only `.shape`."""

    def __init__(self, shape: dict):
        self.shape = shape


def _ref(spec) -> tuple:
    return tuple(spec)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

SPEC_CASES = [
    ((64, 128), ("embed", "heads"), "16x16"),
    ((64, 8), ("embed", "kv_heads"), "16x16"),
    ((64, 32, 32), ("experts", "embed", "mlp"), "16x16"),
    ((64, 128), ("embed", "heads"), "2x16x16"),
    ((8,), ("batch",), "2x16x16"),
    ((256, 4096), ("batch", None), "2x16x16"),
    ((49155, 2048), ("vocab", "embed"), "16x16"),
]


@pytest.mark.parametrize("shape,logical,mesh", SPEC_CASES)
@pytest.mark.parametrize("fsdp", [False, True], ids=["default", "fsdp"])
def test_spec_for_matches_reference(shape, logical, mesh, fsdp):
    sizes = MESHES[mesh]
    rrules = RSH.ShardingRules(RSH.FSDP_RULES if fsdp else None)
    trules = TSH.ShardingRules(TSH.FSDP_RULES if fsdp else None)
    want = RSH.spec_for(shape, logical, FakeMesh(sizes), rrules)
    got = TSH.spec_for(shape, logical, sizes, trules)
    assert got == _ref(want)


def test_spec_for_reference_cases():
    mesh = {"data": 16, "model": 16}
    assert TSH.spec_for((64, 128), ("embed", "heads"), mesh) == \
        TSH.P("data", "model")
    assert TSH.spec_for((64, 8), ("embed", "kv_heads"), mesh) == \
        TSH.P("data", None)
    s = TSH.spec_for((64, 32, 32), ("experts", "embed", "mlp"), mesh)
    used = [a for a in s if a is not None]
    assert len(set(used)) == len(used)
    pod = {"pod": 2, "data": 16, "model": 16}
    assert TSH.spec_for((64, 128), ("embed", "heads"), pod) == \
        TSH.P(("pod", "data"), "model")
    assert TSH.spec_for((8,), ("batch",), pod) == TSH.P(None)


@pytest.mark.parametrize("shape", [(40, 128, 16, 4096, 128),
                                   (88, 128, 8, 32768, 128),
                                   (24, 128, 24, 128, 64), (128, 1500, 384),
                                   (24, 128, 3), (128, 49155), ()])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_decode_state_specs_match_reference(shape, mesh):
    sizes = MESHES[mesh]
    want = RSH.decode_state_specs(
        jax.ShapeDtypeStruct(shape, jnp.bfloat16), FakeMesh(sizes))
    got = TSH.decode_state_specs(torch.empty(shape, device="meta"), sizes)
    assert got == _ref(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", TR.ARCH_NAMES)
def test_param_specs_match_reference(arch, mesh):
    """Every parameter: the port's spec == the reference's stacked leaf's
    spec with its "layers" entry (always None) dropped."""
    sizes = MESHES[mesh]
    rshapes, rlogical = RST.param_shapes_and_specs(RR.get_arch(arch))
    cfg = TR.get_arch(arch)
    tshapes = TT.param_shapes(cfg)
    tspecs = TSH.tree_specs(TT.param_specs(cfg),
                            {n: s for n, (s, _) in tshapes.items()}, sizes)
    for name, (shape, dtype) in tshapes.items():
        path, layer = _lm_slot(name)
        rshape, rlog = rshapes, rlogical
        for key in path:
            rshape, rlog = rshape[key], rlog[key]
        want = RSH.spec_for(tuple(rshape.shape), tuple(rlog),
                            FakeMesh(sizes))
        if layer is not None:
            assert rlog[0] == "layers" and want[0] is None, name
            want = want[1:]
            assert tuple(rshape.shape[1:]) == shape, name
        else:
            assert tuple(rshape.shape) == shape, name
        assert str(rshape.dtype) == str(dtype).replace("torch.", ""), name
        assert tspecs[name] == _ref(want), (name, tspecs[name], want)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_compress_bitwise_reference(seed, scale):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(257,)) * scale).astype(np.float32)
    r = (rng.normal(size=(257,)) * scale * 0.01).astype(np.float32)
    rq, rs, rr = RCOMP.compress(jnp.asarray(g), jnp.asarray(r))
    tq, ts, tr = TCOMP.compress(torch.from_numpy(g), torch.from_numpy(r))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(rr))
    np.testing.assert_array_equal(
        TCOMP.decompress(tq, ts).numpy(),
        np.asarray(RCOMP.decompress(rq, rs)))


def test_compressed_grads_on_a_dict_match_reference():
    rng = np.random.default_rng(3)
    grads = {"a": rng.normal(size=(4, 5)).astype(np.float32),
             "b": rng.normal(size=(7,)).astype(np.float32)}
    rstate = RCOMP.init(jax.eval_shape(
        lambda: {k: jnp.asarray(v) for k, v in grads.items()}))
    tstate = TCOMP.init({k: torch.from_numpy(v) for k, v in grads.items()})
    for _ in range(3):
        rg, rstate = RCOMP.compressed_grads(
            {k: jnp.asarray(v) for k, v in grads.items()}, rstate)
        tg, tstate = TCOMP.compressed_grads(
            {k: torch.from_numpy(v) for k, v in grads.items()}, tstate)
        for k in grads:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(rg[k]))
            np.testing.assert_array_equal(tstate.residual[k].numpy(),
                                          np.asarray(rstate.residual[k]))


def test_compression_roundtrip_error_bounded():
    g = torch.randn(256, generator=torch.Generator().manual_seed(0))
    q, s, _ = TCOMP.compress(g, torch.zeros_like(g))
    assert float((TCOMP.decompress(q, s) - g).abs().max()) <= float(s) / 2 \
        + 1e-6


def test_error_feedback_makes_compression_unbiased_over_time():
    g = torch.tensor([0.003, -0.001, 0.5])    # small values vanish w/o EF
    res = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(200):
        q, s, res = TCOMP.compress(g, res)
        acc = acc + TCOMP.decompress(q, s)
    np.testing.assert_allclose((acc / 200).numpy(), g.numpy(), rtol=0.02,
                               atol=1e-4)


def test_compressed_training_converges():
    gen = torch.Generator().manual_seed(1)
    X = torch.randn(128, 8, generator=gen)
    w_true = torch.randn(8, generator=gen)
    y = X @ w_true
    w = torch.zeros(8)
    state = TCOMP.init(w)
    for _ in range(300):
        wg = w.clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.mean((X @ wg - y) ** 2), wg)
        gq, state = TCOMP.compressed_grads(g, state)
        w = w - 0.05 * gq
    assert float((w - w_true).abs().max()) < 0.05


# ---------------------------------------------------------------------------
# collectives, roofline, elastic plans, the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbytes", [64 * 2 ** 20, 1e6])
def test_collectives_comparison_matches_reference(nbytes):
    assert TCOL.comparison(nbytes) == RCOL.comparison(nbytes)


@pytest.mark.parametrize("n_domains", [2, 4, 16])
def test_hierarchical_all_reduce_matches_reference(n_domains):
    from repro.core import noc as RNOC
    from repro_torch.core import noc as TNOC

    want = RCOL.hierarchical_all_reduce(
        n_domains, RNOC.fullerene_adjacency(), 64 * 2 ** 20)
    got = TCOL.hierarchical_all_reduce(
        n_domains, TNOC.fullerene_adjacency(), 64 * 2 ** 20)
    assert got == want
    adj = TNOC.mesh_2d(4, 8, torus=True)
    assert dataclasses.astuple(TCOL.broadcast_cost(adj, 1e6, "t")) == \
        dataclasses.astuple(RCOL.broadcast_cost(
            RNOC.mesh_2d(4, 8, torus=True), 1e6, "t"))


@pytest.mark.parametrize("arch", TR.ARCH_NAMES)
def test_model_flops_for_matches_reference(arch):
    for shape in TR.SHAPES:
        assert TRL.model_flops_for(TR.get_arch(arch), TR.get_shape(shape)) \
            == RRL.model_flops_for(RR.get_arch(arch), RR.get_shape(shape))


def test_roofline_report_terms():
    costs = TA.TraceCosts(flops=989e12, hbm_bytes=3.35e12 * 2,
                          coll_bytes=450e9 * 3, per_kind={}, op_counts={})
    rep = TRL.analyze_trace("x", costs, model_flops=989e12 * 256, chips=256)
    assert (rep.t_compute, rep.t_memory, rep.t_collective) == (1.0, 2.0,
                                                               3.0)
    assert rep.bottleneck == "collective" and rep.t_bound == 3.0
    assert rep.useful_flops_ratio == 1.0
    assert abs(rep.roofline_fraction - 1 / 3) < 1e-12
    assert set(rep.row()) == {
        "name", "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
        "hlo_flops", "hlo_bytes", "coll_bytes", "model_flops",
        "useful_ratio", "roofline_fraction", "collective_ops"}


@pytest.mark.parametrize("n,mp", [(512, 16), (496, 16), (7, 16), (4, 2),
                                  (2, 2), (256, 1), (96, 64)])
def test_elastic_plan_matches_reference(n, mp):
    want = RElasticPlan.plan(n, model_parallel=mp)
    got = TElasticPlan.plan(n, model_parallel=mp)
    assert (got.n_devices, got.mesh_shape, got.axes) == (
        want.n_devices, want.mesh_shape, want.axes)


def test_registry_cells_and_input_specs_match_reference():
    assert TR.runnable_cells() == RR.runnable_cells()
    assert TR.runnable_cells(smoke=True) == RR.runnable_cells(smoke=True)
    for arch in TR.ARCH_NAMES:
        for shape in TR.SHAPES:
            want = RR.input_specs(RR.get_arch(arch), RR.get_shape(shape))
            got = TR.input_specs(TR.get_arch(arch), TR.get_shape(shape))
            assert list(got) == list(want), (arch, shape)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape)
                assert str(t.dtype).replace("torch.", "") == str(
                    want[k].dtype), (arch, shape, k)


# ---------------------------------------------------------------------------
# the trace analyzer
# ---------------------------------------------------------------------------

def test_trace_counts_a_matmul_loop():
    w = torch.randn(64, 64)
    x = torch.randn(64, 64)

    def loop():
        y = x
        for _ in range(10):
            y = y @ w
        return y

    costs = TA.trace(loop)
    assert costs.flops == 10 * 2 * 64 ** 3
    assert costs.hbm_bytes == 10 * 3 * 64 * 64 * 4
    assert costs.coll_bytes == 0


def test_trace_prices_a_one_row_cache_write():
    cache = torch.zeros(100000, 128)
    row = torch.randn(128)
    idx = torch.tensor([5])

    def write():
        cache[7] = row
        cache.index_copy_(0, idx, row[None])

    costs = TA.trace(write)
    assert 0 < costs.hbm_bytes < cache.numel() * 4 / 10
    assert costs.flops == 0


def test_trace_counts_local_flops_on_a_fake_world():
    """A (4096 x 4096) product with the weight sharded 16 ways counts 1/16
    of the global FLOPs on a device; its collectives by kind."""
    script = textwrap.dedent("""
        import torch, torch.distributed as dist, json
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=16)
        from torch.distributed.device_mesh import init_device_mesh
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.distributed import sharding as SH
        from repro_torch.distributed import trace_analysis as TA
        mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
        with FakeTensorMode() as fake:
            x = torch.empty(4096, 4096)
            w = torch.empty(4096, 4096)
        xd = SH.shard(x, SH.P(None, None), mesh)
        wd = SH.shard(w, SH.P(None, "model"), mesh)
        y = TA.trace(lambda: xd @ wd, fake_mode=fake)
        full = TA.trace(lambda: (xd @ wd).full_tensor(), fake_mode=fake)
        print(json.dumps([y.flops, full.per_kind, list(
            SH.placements(SH.P(None, "model"), mesh))
            == list(wd.placements)]))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=dict(os.environ,
                                             PYTHONPATH=str(ROOT / "src")),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    flops, per_kind, same = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert flops == 2 * 4096 ** 3 / 16
    assert per_kind["all-gather"] == 4096 * 4096 * 4
    assert same


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_world(multi_pod):
    """Like the reference, the production mesh refuses any world but 256
    (or 512) ranks, naming what the dry run must set up."""
    from repro_torch.launch import mesh as TMESH

    n = 512 if multi_pod else 256
    with pytest.raises(RuntimeError, match=f"need a world of {n} ranks"):
        TMESH.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError, match=f"plan for {n} devices"):
        TElasticPlan.plan(n, model_parallel=16).build_mesh()
