"""The port's train→deploy pipeline (`repro_torch.deploy`: per-core PTQ,
the parity gates, `deploy`, `continual_adaptation`), its quant helpers,
`scripts/torch_profile_report.py` and `examples/torch_train_deploy_nmnist.py`
against the JAX package, on the CPU.

The fixtures are `tests/test_deploy.py`'s: `EventStream(timesteps=5,
height=8, width=8, seed=2)` into a (128, 64, 10) QAT net.  Both sides
deploy the same JAX-trained parameters, so everything the pipeline
computes is held to the reference's: integers and accuracies equal,
float fields within `REPORT_REL` (the port's own `deploy` on a fused and
a compiled chip).  Per-core codebooks are k-means fits that sum clusters
in another order in each framework: register words and indexes are
equal, codebooks, scales and weights within `QAT_ULP`, RMS errors
within `REPORT_REL`.  `continual_adaptation` runs with its trainer
stubbed on both sides to one fixed parameter set, so the scenario after
training is held to the reference's on the three port engines.
"""
import dataclasses
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.deploy.adapt as REF_ADAPT  # noqa: E402
from repro import compiler as REF_COMP  # noqa: E402
from repro import deploy as REF_DEP  # noqa: E402
from repro.core import quant as REF_Q  # noqa: E402
from repro.core import soc as REF_SOC  # noqa: E402
from repro.data import synthetic as REF_D  # noqa: E402
from repro.models import snn as REF_SNN  # noqa: E402
from repro.train import snn_trainer as REF_TR  # noqa: E402

import repro_torch.deploy.adapt as ADAPT  # noqa: E402
import repro_torch.deploy.pipeline as PIPE  # noqa: E402
from repro_torch import compiler as COMP  # noqa: E402
from repro_torch import deploy as DEP  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core import soc as SOC  # noqa: E402
from repro_torch.core.neuron import LIFParams  # noqa: E402
from repro_torch.data import synthetic as D  # noqa: E402
from repro_torch.models import snn as SNN  # noqa: E402
from repro_torch.train import snn_trainer as TR  # noqa: E402

from test_torch_harness import REPORT_REL, min_tie_margin  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
QAT_ULP = 4            # per-core fits: equal words, levels a few ulp apart
MARGIN = 1e-5          # tie-free chip runs: |v_int - theta| > MARGIN

EV_KW = dict(timesteps=5, height=8, width=8, seed=2)
EV, REF_EV = D.EventStream(**EV_KW), REF_D.EventStream(**EV_KW)
SIZES = (EV.n_inputs, 64, 10)
CFG = SNN.SNNConfig(layer_sizes=SIZES, timesteps=5, qat=True)
REF_CFG = REF_SNN.SNNConfig(layer_sizes=SIZES, timesteps=5, qat=True)
HW = dict(rate_weight=1.0, target_rate=0.05)
# the end-to-end deploy of tests/test_deploy.py: 10 steps, eval 64
TRAIN = dict(steps=10, lr=8e-3)
EVAL_BATCH = 64
GATES = dict(accuracy_tol=0.06)
PJ_FIELDS = ("write_energy_pj", "infer_energy_pj", "upload_energy_pj",
             "onchip_total_pj", "write_pj_share", "offline_dma_pj",
             "offline_reprogram_pj", "offline_total_pj",
             "onchip_advantage_x")


def _ulp_diff(got, want) -> float:
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(g - w) / np.spacing(np.maximum(np.abs(w),
                                                               1e-30))))


def _rel_close(got: float, want: float, rel: float = REPORT_REL) -> bool:
    """Within `rel` of max(|want|, 1), the harness's report rule."""
    return abs(got - want) <= rel * max(abs(want), 1.0)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, x


def _ref_params(seed=1):
    return REF_SNN.init_params(REF_CFG, jax.random.PRNGKey(seed))


# ---------------------------------------------------------------------------
# the quant helpers


@pytest.mark.parametrize("shape", [(6,), (7,), (3, 5), (2, 3, 9), (4, 16)])
def test_pack_indexes_4bit_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    # [0, 16) and then all of int8: the reference wraps and truncates an
    # index outside the 4-bit range in uint8, so must the port
    for lo, hi in ((0, 16), (-128, 128)):
        idx = rng.integers(lo, hi, shape).astype(np.int8)
        got = Q.pack_indexes_4bit(torch.tensor(idx))
        want = np.asarray(REF_Q.pack_indexes_4bit(jnp.asarray(idx)))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        back = Q.unpack_indexes_4bit(got, shape[-1])
        np.testing.assert_array_equal(
            back.numpy(),
            np.asarray(REF_Q.unpack_indexes_4bit(jnp.asarray(want),
                                                 shape[-1])))
        if lo == 0:
            np.testing.assert_array_equal(back.numpy(), idx)   # round trip
    with pytest.raises(TypeError, match="int8"):
        Q.pack_indexes_4bit(torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("shape", [(1,), (7,), (64, 10), (3, 5, 7),
                                   (2312, 4096)])
@pytest.mark.parametrize("n,w", [(4, 4), (8, 8), (16, 8), (16, 16), (32, 8)])
def test_memory_bytes_equal(shape, n, w):
    # N = 32 is no chip table (CodebookConfig refuses it); both functions
    # take any object with the fields, and packing only helps N <= 16
    cfg, ref = ((Q.CodebookConfig(n, w), REF_Q.CodebookConfig(n, w))
                if n <= 16 else
                (types.SimpleNamespace(n_levels=n, bit_width=w,
                                       index_bits=5),) * 2)
    for groups in (1, 3):
        assert Q.memory_bytes(shape, cfg, groups) == \
            REF_Q.memory_bytes(shape, ref, groups)
        assert Q.packed_memory_bytes(shape, cfg, groups) == \
            REF_Q.packed_memory_bytes(shape, ref, groups)


@pytest.mark.parametrize("shape,n", [((37,), 16), ((5, 7), 8),
                                     ((3, 4, 9), 4), ((2, 8), 16)])
def test_quantization_error_matches_reference(shape, n):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = Q.quantization_error(torch.tensor(w), Q.CodebookConfig(n, 8))
    want = float(REF_Q.quantization_error(jnp.asarray(w),
                                          REF_Q.CodebookConfig(n, 8)))
    assert got.dtype == torch.float32 and got.dim() == 0
    # k-means levels a few ulp apart move the f32 RMS in its last digits
    assert _rel_close(float(got), want), (float(got), want)


# ---------------------------------------------------------------------------
# per-core PTQ


def _split_mapping(soc):
    """Layer 1 on three cores of uneven widths, layer 2 on one."""
    A = soc.CoreAssignment
    return soc.Mapping(
        assignments=[A(12, 1, 0, 7), A(13, 1, 7, 37), A(14, 1, 37, 64),
                     A(15, 2, 0, 10)], layer_sizes=list(SIZES))


def _mappings(kind, rparams):
    if kind == "split3":
        return _split_mapping(REF_SOC), _split_mapping(SOC)
    ref = REF_COMP.compile_network(REF_COMP.from_weights(rparams),
                                   strategy="anneal").to_soc_mapping()
    port = COMP.compile_network(
        COMP.from_weights([torch.tensor(np.asarray(w)) for w in rparams]),
        strategy="anneal").to_soc_mapping()
    assert [dataclasses.astuple(a) for a in port.assignments] == \
        [dataclasses.astuple(a) for a in ref.assignments]
    return ref, port


# each case compiles the reference's fit per slice shape, about a second
# each: the placer's mapping plain, the hand split with a zero level
@pytest.mark.parametrize("kind,zero_level", [("anneal", False),
                                             ("split3", True)])
def test_fit_per_core_matches_reference(kind, zero_level):
    rparams = _ref_params()
    rmap, pmap = _mappings(kind, rparams)
    assert max(len(rmap.cores_of_layer(li)) for li in (1, 2)) >= 3
    ref = REF_DEP.fit_per_core_codebooks(
        rparams, rmap, REF_Q.CodebookConfig(16, 8, zero_level=zero_level))
    got = DEP.fit_per_core_codebooks(
        [torch.tensor(np.asarray(w)) for w in rparams], pmap,
        Q.CodebookConfig(16, 8, zero_level=zero_level))
    assert got.n_tables == ref.n_tables == len(rmap.assignments)
    assert got.table_bits() == ref.table_bits()
    for g, r in zip(got.tables, ref.tables):
        assert (g.core_id, g.codebook_words, g.weight_levels,
                g.weight_bits, g.threshold, g.leak, g.reset) == \
            (r.core_id, r.codebook_words, r.weight_levels, r.weight_bits,
             r.threshold, r.leak, r.reset)
        # the scale is max |centroid| / 127: centroids a few ulp apart
        assert _ulp_diff(g.codebook_scale, r.codebook_scale) <= QAT_ULP
    assert got.slices.keys() == ref.slices.keys()
    for key, rq in ref.slices.items():
        gq = got.slices[key]
        assert gq.group_axis_size == rq.group_axis_size == 0
        np.testing.assert_array_equal(gq.idx.numpy(), np.asarray(rq.idx))
        assert _ulp_diff(gq.codebook.numpy(), rq.codebook) <= QAT_ULP, key
    for g, r in zip(got.weights, ref.weights):
        assert g.dtype == torch.float32
        assert _ulp_diff(g.numpy(), r) <= QAT_ULP
    assert len(got.rms_error) == len(ref.rms_error)
    for g, r in zip(got.rms_error, ref.rms_error):
        assert type(g) is float and abs(g - r) <= REPORT_REL * abs(r)


def test_fit_per_core_ignores_group_size():
    """A grouped CodebookConfig must not break the per-core fit: one
    whole-slice table per core, and the RegisterTable holds exactly the
    codebook the executed weights dequantize through."""
    params = [torch.tensor(np.asarray(w)) for w in _ref_params()]
    mapping = SOC.map_network(list(SIZES), strategy="anneal")
    grouped = Q.CodebookConfig(16, 8, group_size=24)  # does not divide slices
    pq = DEP.fit_per_core_codebooks(params, mapping, grouped)
    for a in mapping.assignments:
        q = pq.slices[(a.layer, a.core_id)]
        assert q.group_axis_size == 0                # whole-slice codebook
        rt = next(t for t in pq.tables if t.core_id == a.core_id)
        np.testing.assert_array_equal(rt.codebook(), q.codebook[0].numpy())
        np.testing.assert_array_equal(
            pq.weights[a.layer - 1][:, a.neuron_lo:a.neuron_hi].numpy(),
            Q.dequantize(q).numpy())


def test_fit_per_core_rejects_incomplete_mapping():
    rparams = _ref_params()
    params = [torch.tensor(np.asarray(w)) for w in rparams]
    cases = []
    for soc in (REF_SOC, SOC):
        mapping = soc.map_network(list(SIZES), strategy="anneal")
        no_layer2 = dataclasses.replace(
            mapping, assignments=[a for a in mapping.assignments
                                  if a.layer != 2])
        gap = dataclasses.replace(
            mapping, assignments=[a for a in mapping.assignments
                                  if not (a.layer == 1 and a.neuron_lo == 0)])
        cases.append((no_layer2, gap))
    for (rbad, pbad), want in zip(zip(*cases), ("layer 2", "layer 1")):
        with pytest.raises(ValueError, match=want) as ref_err:
            REF_DEP.fit_per_core_codebooks(rparams, rbad,
                                           REF_Q.CodebookConfig(16, 8))
        with pytest.raises(ValueError, match=want) as got_err:
            DEP.fit_per_core_codebooks(params, pbad, Q.CodebookConfig(16, 8))
        assert str(got_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# the parity gates


@pytest.mark.parametrize("gates", [
    dict(), dict(accuracy_tol=0.25, pj_per_sop_target=0.5, pj_margin=2.0),
    dict(accuracy_tol=0.01, pj_per_sop_target=0.96, pj_margin=1.25)])
def test_parity_gates_check_equals_reference(gates):
    got, ref = DEP.ParityGates(**gates), REF_DEP.ParityGates(**gates)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    edge_pj = ref.pj_per_sop_target * ref.pj_margin
    accs = (0.0, 0.5, 0.75, 0.95, 0.945, 0.94, 1.0)
    pjs = (0.0, 0.5, np.nextafter(edge_pj, 0.0), edge_pj,
           np.nextafter(edge_pj, 2.0 * edge_pj), 1.5)
    for a in accs:
        for b in accs + (a - ref.accuracy_tol, a + ref.accuracy_tol):
            for pj in pjs:
                want = ref.check(a, b, float(pj))
                assert got.check(a, b, float(pj)) == want, (a, b, pj)
    # the edges: pJ/SOP of exactly target x margin passes and the next
    # float fails; a delta of exactly the tolerance passes (0.25 is exact
    # in binary, so its grid holds such pairs)
    assert got.check(0.5, 0.5, edge_pj)["energy_ok"]
    assert not got.check(0.5, 0.5, float(np.nextafter(
        edge_pj, 2.0 * edge_pj)))["energy_ok"]
    exact = [(a, b) for a in accs for b in accs
             if abs(a - b) == ref.accuracy_tol]
    assert exact or ref.accuracy_tol != 0.25
    for a, b in exact:
        assert got.check(a, b, 0.0)["accuracy_parity_ok"]


# ---------------------------------------------------------------------------
# deploy


@pytest.fixture(scope="module")
def ref_deploy():
    """JAX-trained params (10 steps) and the JAX deploy of them."""
    tcfg = REF_TR.SNNTrainConfig(hw=REF_TR.HWLossConfig(**HW), **TRAIN)
    params, _ = REF_TR.SNNTrainer(REF_CFG, tcfg).fit(
        lambda step: REF_EV.batch(tcfg.batch, step))
    report = REF_DEP.deploy(
        REF_CFG, REF_EV, REF_DEP.DeployConfig(
            train=tcfg, gates=REF_DEP.ParityGates(**GATES),
            eval_batch=EVAL_BATCH), params=params)
    return [np.asarray(p) for p in params], report.to_dict()


def _port_dcfg(**kw):
    return DEP.DeployConfig(
        train=TR.SNNTrainConfig(hw=TR.HWLossConfig(**HW), **TRAIN),
        gates=DEP.ParityGates(**GATES), eval_batch=EVAL_BATCH, **kw)


def _capture_sims(monkeypatch) -> list:
    built = []

    def build(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    real = PIPE._build_sim
    monkeypatch.setattr(PIPE, "_build_sim", build)
    return built


@pytest.mark.parametrize("engine", ["fused", "compiled"])
def test_deploy_matches_reference(ref_deploy, engine, monkeypatch):
    params, want = ref_deploy
    sims = _capture_sims(monkeypatch)
    got = DEP.deploy(CFG, EV, _port_dcfg(engine=engine), params=params,
                     device="cpu").to_dict()
    # the chip runs are tie-free: spikes cannot flip on rounding
    sim = sims[0]
    assert sim.engine == engine and len(sims) == 2
    if engine == "fused":
        assert sim.fused_engine().codebook_layers == len(SIZES) - 1
    eval_sp, _ = EV.batch(EVAL_BATCH, PIPE.DeployConfig.eval_step,
                          device="cpu")
    assert min_tie_margin([w.numpy() for w in sim.weights], sim.lif,
                          eval_sp.numpy()) > MARGIN

    assert got.keys() == want.keys()
    for key in ("layer_sizes", "timesteps", "n_levels", "bit_width", "qat",
                "regularized", "train_steps", "eval_samples", "final_loss",
                "acc_train", "acc_dequant", "acc_chip", "n_cores",
                "n_register_tables", "compile_summary", "gates"):
        assert got[key] == want[key], key
    for key in ("sparsity", "touch_fraction", "nominal_sops",
                "performed_sops", "pj_per_sop", "energy_pj", "power_mw",
                "gsops", "wall_cycles", "noc_energy_pj", "noc_hops"):
        assert _rel_close(got[key], want[key]), key
    for g, r in zip(got["quant_rms_error"], want["quant_rms_error"]):
        assert abs(g - r) <= REPORT_REL * abs(r)
    gp, wp = got["chip_profile"], want["chip_profile"]
    assert gp.keys() == wp.keys()
    for (path, g), (wpath, w) in zip(_leaves(gp), _leaves(wp)):
        assert path == wpath
        if isinstance(w, float):
            assert abs(g - w) <= REPORT_REL * abs(w), path
        else:
            assert g == w, path                     # hotspot names, counts
    # the serving smoke: host clocks (latency, throughput) are not
    # comparable across frameworks; the rest is
    for key in ("requests", "served", "shed", "dma_pj_per_request",
                "model_swap_pj"):
        assert got["serving_slo"][key] == want["serving_slo"][key], key
    assert got["serving_slo"].keys() == want["serving_slo"].keys()


def test_deploy_marks_each_stage_with_a_span(ref_deploy, monkeypatch):
    """Each stage of `deploy()` runs in a `torch.profiler.record_function`
    span `deploy.<stage>`, a simulator's lowering in `soc.lower` inside
    the stage whose first run builds it: `chip_smoke.py` phase 11 reads
    its stage seconds from these names.  A recorder in place of
    `record_function` sees each span with the spans around it."""
    seen, stack = [], []
    real = torch.profiler.record_function

    class Recorder(real):
        def __enter__(self):
            seen.append((self.name, tuple(stack)))
            stack.append(self.name)
            return super().__enter__()

        def __exit__(self, *exc):
            stack.pop()
            return super().__exit__(*exc)

    monkeypatch.setattr(torch.profiler, "record_function", Recorder)
    params, _ = ref_deploy
    DEP.deploy(CFG, EV, _port_dcfg(engine="compiled"), params=params,
               device="cpu")
    ours = [(n, tuple(o for o in outer if o.startswith(("deploy.", "soc."))))
            for n, outer in seen if n.startswith(("deploy.", "soc."))]
    assert ours == [
        ("deploy.accuracy", ()), ("deploy.compile", ()), ("deploy.ptq", ()),
        ("deploy.accuracy", ()), ("deploy.build_sim", ()),
        ("deploy.chip_eval", ()), ("soc.lower", ("deploy.chip_eval",)),
        ("deploy.profile", ()), ("deploy.build_sim", ("deploy.profile",)),
        ("soc.lower", ("deploy.profile",)), ("deploy.serving_smoke", ())]


def test_deploy_trains_on_the_port(tmp_path, monkeypatch):
    seen = {}

    class Recording(TR.SNNTrainer):
        def fit(self, *a, **kw):
            params, history = super().fit(*a, **kw)
            seen["history"] = history
            return params, history

    monkeypatch.setattr(PIPE, "SNNTrainer", Recording)
    rep = DEP.deploy(CFG, EV, _port_dcfg(), device="cpu")
    losses = [r["loss"] for r in seen["history"]]
    assert len(losses) == TRAIN["steps"] and losses[-1] < losses[0]
    assert rep.final_loss == losses[-1]
    doc = rep.to_dict()
    for path, leaf in _leaves(doc):
        assert leaf is None or type(leaf) in (bool, int, float, str), \
            (path, type(leaf))
        if type(leaf) is float:
            assert np.isfinite(leaf), path
    out = tmp_path / "report.json"
    rep.save(str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    assert rep.passed == rep.gates["passed"]
    assert rep.n_register_tables == rep.n_cores
    assert "PASS" in rep.summary() or "FAIL" in rep.summary()


def test_reset_mode_alone_picks_the_compiled_engine(ref_deploy, monkeypatch,
                                                    capsys):
    """The reference sends a soft-reset model to the compiled engine (the
    fused kernel has the chip's hard reset only) and says so; nothing
    else moves a run off the fused engine: an engine failure propagates."""
    params, _ = ref_deploy
    sims = _capture_sims(monkeypatch)
    soft = dataclasses.replace(CFG, lif=LIFParams(reset_mode="soft"))
    DEP.deploy(soft, EV, _port_dcfg(verbose=True), params=params,
               device="cpu")
    assert [s.engine for s in sims] == ["compiled", "compiled"]
    assert "reset_mode='soft' not supported by the fused kernel" in \
        capsys.readouterr().out

    def fail(self, *a, **kw):
        raise RuntimeError("the fused run failed")

    from repro_torch.core.engine import FusedEngine
    monkeypatch.setattr(FusedEngine, "run_raw", fail)
    with pytest.raises(RuntimeError, match="the fused run failed"):
        DEP.deploy(CFG, EV, _port_dcfg(), params=params, device="cpu")


def test_deploy_refuses_data_off_its_device(ref_deploy):
    """A batch that does not arrive on the pipeline's device is an error,
    never a copy per chunk."""
    params, _ = ref_deploy

    class Elsewhere:
        def batch(self, n, step, device=None):
            s, l = EV.batch(n, step, device=device)
            return s.to("meta"), l

    with pytest.raises(ValueError, match="lies on meta"):
        DEP.deploy(CFG, Elsewhere(), _port_dcfg(), params=params,
                   device="cpu")
    with pytest.raises(ValueError, match="params lies on meta"):
        DEP.deploy(CFG, EV, _port_dcfg(), device="cpu",
                   params=[torch.tensor(p).to("meta") for p in params])


# ---------------------------------------------------------------------------
# continual adaptation


@pytest.fixture(scope="module")
def adapt_params():
    """One fixed parameter set for both trainers: the port's QAT fit of
    the scenario's default network (deterministic on the CPU)."""
    cfg = ADAPT.AdaptConfig()
    ev = D.EventStream(height=cfg.height, width=cfg.width,
                       timesteps=cfg.timesteps, seed=cfg.seed)
    net = SNN.SNNConfig(layer_sizes=(ev.n_inputs, cfg.hidden, cfg.n_classes),
                        timesteps=cfg.timesteps, qat=True,
                        quant=Q.CodebookConfig(cfg.n_levels, cfg.bit_width))
    params, _ = TR.SNNTrainer(net, TR.SNNTrainConfig(
        steps=30, batch=cfg.train_batch, lr=cfg.train_lr, log_every=0),
        device="cpu").fit(
            lambda step: ev.batch(cfg.train_batch, step, device="cpu"))
    return [p.detach().numpy().copy() for p in params]


def _stub_trainer(params, to_array):
    class Stub:
        def __init__(self, *a, **kw):
            pass

        def fit(self, *a, **kw):
            return [to_array(p) for p in params], []

    return Stub


ADAPT_KW = dict(n_trials=16, eval_batch=32)


@pytest.fixture(scope="module")
def ref_adapt(adapt_params):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(REF_ADAPT, "SNNTrainer",
                   _stub_trainer(adapt_params, jnp.asarray))
        return REF_DEP.continual_adaptation(
            REF_DEP.AdaptConfig(**ADAPT_KW)).to_dict()


@pytest.mark.parametrize("engine", ["compiled", "fused", "reference"])
def test_continual_adaptation_matches_reference(adapt_params, ref_adapt,
                                                engine, monkeypatch):
    monkeypatch.setattr(ADAPT, "SNNTrainer",
                        _stub_trainer(adapt_params, torch.tensor))
    got = DEP.continual_adaptation(
        DEP.AdaptConfig(engine=engine, **ADAPT_KW), device="cpu").to_dict()
    want = ref_adapt
    assert got.keys() == want.keys()
    # the drift must cost accuracy for recovered_frac to mean anything
    assert want["acc_base"] > want["acc_drift"]
    for key in ("acc_base", "acc_drift", "acc_adapted", "recovered_frac",
                "recovery_frac_gate", "recovered", "n_trials",
                "weight_writes"):
        assert got[key] == want[key], key
    assert want["weight_writes"] > 0
    for key in PJ_FIELDS:
        assert abs(got[key] - want[key]) <= REPORT_REL * abs(want[key]), key


def test_adaptation_keeps_learned_indexes_on_the_device(adapt_params,
                                                        monkeypatch):
    """Every trial warm-starts from the last commit's indexes as the
    engine left them (a view of `last_learned`), not a host round trip."""
    monkeypatch.setattr(ADAPT, "SNNTrainer",
                        _stub_trainer(adapt_params, torch.tensor))
    warm = []
    real = SOC.ChipSimulator.run_batch

    def run_batch(self, spikes, learned=None):
        if learned is not None and self.last_learned is not None:
            warm.append(all(
                l is None or l.untyped_storage().data_ptr()
                == s.untyped_storage().data_ptr()
                for l, s in zip(learned, self.last_learned)))
        return real(self, spikes, learned=learned)

    monkeypatch.setattr(SOC.ChipSimulator, "run_batch", run_batch)
    DEP.continual_adaptation(DEP.AdaptConfig(engine="fused", **ADAPT_KW),
                             device="cpu")
    assert len(warm) == ADAPT_KW["n_trials"] and all(warm)


# ---------------------------------------------------------------------------
# defaults, the script and the example


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    params = [np.asarray(w) for w in _ref_params()]
    mapping = SOC.map_network(list(SIZES), strategy="anneal")
    for call in (
            lambda: DEP.deploy(CFG, EV, _port_dcfg(), params=params),
            lambda: DEP.continual_adaptation(DEP.AdaptConfig(**ADAPT_KW)),
            lambda: DEP.fit_per_core_codebooks(params, mapping,
                                               Q.CodebookConfig(16, 8)),
            lambda: Q.quantization_error(params[0],
                                         Q.CodebookConfig(16, 8))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("net", ["tiny", "probe"])
def test_profile_report_script_matches_reference(net, tmp_path):
    ref_script = _load(ROOT / "scripts" / "profile_report.py",
                       "ref_profile_report")
    port_script = _load(ROOT / "scripts" / "torch_profile_report.py",
                        "torch_profile_report")
    assert port_script.NETS == ref_script.NETS
    args = ["--net", net, "--engine", "fused"]
    assert ref_script.main(args + ["--json", str(tmp_path / "ref.json")]) \
        == 0
    assert port_script.main(args + ["--device", "cpu", "--json",
                                    str(tmp_path / "port.json")]) == 0
    want = list(_leaves(json.loads((tmp_path / "ref.json").read_text())))
    got = list(_leaves(json.loads((tmp_path / "port.json").read_text())))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(w, float):
            assert abs(g - w) <= REPORT_REL * abs(w), path
        else:
            assert g == w, path


def test_example_writes_a_report_with_reference_keys(tmp_path):
    example = _load(ROOT / "examples" / "torch_train_deploy_nmnist.py",
                    "torch_train_deploy_nmnist")
    out = tmp_path / "deploy_report.json"
    rc = example.main(["--tiny", "--steps", "3", "--device", "cpu",
                       "--out", str(out)])
    doc = json.loads(out.read_text())
    assert list(doc) == [f.name for f in
                         dataclasses.fields(REF_DEP.DeployReport)]
    assert doc["train_steps"] == 3 and doc["layer_sizes"] == [288, 128, 10]
    assert rc == (0 if doc["gates"]["passed"] else 1)
