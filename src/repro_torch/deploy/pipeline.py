"""The end-to-end hardware-aware training→deploy pipeline, in torch.
Port of `repro.deploy.pipeline`.

One call — `deploy(cfg, data)` — closes the loop between "train an SNN"
and "simulate the chip":

    train     surrogate-gradient BPTT with hardware-aware losses
              (train.snn_trainer: spike-rate regularization for the ZSPE
              skip rate, L1 pruning for the partial-update fraction,
              codebook QAT via the STE fake-quant)
    quantize  per-core codebook PTQ (deploy.quantize) — one N×W-bit table
              per placed core, lowered to RegisterTable words
    compile   repro_torch.compiler partition→place→route with
              profile-guided spike rates measured from the trained network
    execute   the batched chip engine over the mapped chip — by default
              core.engine.FusedEngine (one fused-timestep kernel per
              layer-step: bitpacked spike words, per-core register tables
              dequantized in the kernel, fused LIF), with
              engine="compiled" as the dense option

and returns a `DeployReport` whose parity gates assert that the chip
reproduces the trained model's accuracy (within tolerance) and lands
within a margin of the paper's 0.96 pJ/SOP NMNIST figure.

Each stage runs inside a `torch.profiler.record_function` span named
`deploy.<stage>` (train, accuracy, compile, ptq, build_sim, chip_eval,
profile, serving_smoke), so a profiler over one call reads the seconds
of each; the simulator's lowering is its own span, `soc.lower`, nested in
the stage whose first run builds it.

Everything runs on `device` (default: the card).  The data object's
batches are asked for on that device and must arrive there: a batch on
another device is an error, never a copy per chunk.  Device values cross
to the host once each (accuracies, spike rates, a chunk's counts); the
report is plain Python.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import compiler as COMP
from repro_torch.core.soc import ChipSimulator
from repro_torch.deploy.quantize import PerCoreQuant, fit_per_core_codebooks
from repro_torch.deploy.report import DeployReport, ParityGates
from repro_torch.device import resolve_device
from repro_torch.models import snn as SNN
from repro_torch.models.snn import SNNConfig
from repro_torch.serve import SERVED, SnnRequest, SnnServer
from repro_torch.telemetry import TraceConfig, profile, profile_summary
from repro_torch.train.snn_trainer import SNNTrainConfig, SNNTrainer


@dataclasses.dataclass(frozen=True)
class DeployConfig:
    train: SNNTrainConfig = SNNTrainConfig()
    gates: ParityGates = ParityGates()
    mapping_strategy: str = "anneal"
    chip_freq_hz: float = 100e6
    eval_batch: int = 256
    eval_step: int = 999_983        # data seed-step held out from training
    chip_chunk: int = 64            # chip-engine batch per run_batch
    engine: str = "fused"           # chip execution engine; the fused
                                    # kernel consumes the per-core
                                    # RegisterTables directly (codebook
                                    # dequant in the kernel)
    prune_zero_level: bool | None = None   # None => follow hw.l1_weight > 0
    verbose: bool = False


def _on_device(what: str, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`t` itself when it lies on `dev`; raises otherwise (no copy)."""
    if t.device.type != dev.type or (dev.index is not None
                                     and t.device.index != dev.index):
        raise ValueError(f"{what} lies on {t.device}, the pipeline runs on "
                         f"{dev}: hand it tensors on {dev}")
    return t


def _batch(data, n: int, step: int, dev: torch.device):
    spikes, labels = data.batch(n, step, device=dev)
    return (_on_device("data batch spikes", spikes, dev),
            _on_device("data batch labels", labels, dev))


def _param(w, dev: torch.device) -> torch.Tensor:
    """A given parameter as an f32 tensor on `dev`: arrays are copied
    there once; a tensor must already lie there."""
    if isinstance(w, torch.Tensor):
        return _on_device("params", w, dev).detach().to(torch.float32)
    return torch.as_tensor(np.array(w, np.float32), device=dev)


def _accuracy(params, cfg: SNNConfig, spikes, labels) -> float:
    with torch.profiler.record_function("deploy.accuracy"), torch.no_grad():
        return float(SNN.accuracy(params, cfg, spikes, labels))


def _compile(params, spikes, cfg: SNNConfig, strategy: str):
    """Profile-guided compile: spike rates of one eval train, then
    partition -> place -> route."""
    rates = COMP.measure_spike_rates(params, spikes, lif=cfg.lif)
    graph = COMP.from_weights(params, spike_rates=rates)
    return COMP.compile_network(graph, strategy=strategy)


def _build_sim(pq: PerCoreQuant, mapping, cfg: SNNConfig,
               dcfg: DeployConfig, engine: str, dev: torch.device,
               trace: TraceConfig | None = None) -> ChipSimulator:
    with torch.profiler.record_function("deploy.build_sim"):
        return ChipSimulator(pq.weights, freq_hz=dcfg.chip_freq_hz,
                             mapping=mapping, register_tables=pq.tables,
                             lif=cfg.lif, engine=engine, trace=trace,
                             device=dev)


def _chip_eval(sim: ChipSimulator, spikes, labels, chunk: int):
    """Run the eval set through the chip engine in fixed-size chunks and
    aggregate the accounting; each chunk's counts cross to the host in
    one copy."""
    B = int(spikes.shape[0])
    counts_all = []
    acc_stats = dict(nominal=0.0, performed=0.0, touched=0.0, wall=0.0,
                     energy=0.0, noc_pj=0.0, noc_hops=0.0)
    t_steps = int(spikes.shape[1])
    for lo in range(0, B, chunk):
        batch = spikes[lo:lo + chunk]
        counts, reports = sim.run_batch(batch)
        counts_all.append(counts.cpu().numpy())
        for r in reports:
            acc_stats["nominal"] += r.stats.nominal_sops
            acc_stats["performed"] += r.stats.performed_sops
            acc_stats["touched"] += r.stats.neurons_touched
            acc_stats["wall"] += r.wall_cycles
            acc_stats["energy"] += r.energy_pj
            acc_stats["noc_pj"] += r.noc_energy_pj
            acc_stats["noc_hops"] += r.stats.noc_hops
    counts = np.concatenate(counts_all, axis=0)
    acc = float(np.mean(np.argmax(counts, axis=-1) == labels.cpu().numpy()))
    hidden = float(sum(sim.mapping.layer_sizes[1:]))
    agg = {
        "accuracy": acc,
        "sparsity": 1.0 - acc_stats["performed"] / max(acc_stats["nominal"], 1.0),
        "touch_fraction": acc_stats["touched"] / max(B * t_steps * hidden, 1.0),
        "nominal_sops": acc_stats["nominal"],
        "performed_sops": acc_stats["performed"],
        "pj_per_sop": acc_stats["energy"] / max(acc_stats["nominal"], 1.0),
        "energy_pj": acc_stats["energy"],
        "wall_cycles": acc_stats["wall"],
        "noc_energy_pj": acc_stats["noc_pj"],
        "noc_hops": acc_stats["noc_hops"],
        # power/throughput over the whole eval sweep
        "power_mw": (acc_stats["energy"] * 1e-12
                     / max(acc_stats["wall"] / sim.freq_hz, 1e-12) * 1e3),
        "gsops": (acc_stats["nominal"]
                  / max(acc_stats["wall"] / sim.freq_hz, 1e-12) / 1e9),
    }
    return counts, agg


def _chip_profile(pq: PerCoreQuant, mapping, cfg: SNNConfig,
                  dcfg: DeployConfig, engine: str, dev: torch.device,
                  spikes) -> dict:
    """Re-run a small slice of the eval set traced so the report embeds
    the per-layer/per-core hotspot attribution (DESIGN.md §8).  The
    traced simulator shares the mapping and register tables, so the
    profile is of exactly the deployed configuration."""
    prof_batch = spikes[:min(16, int(spikes.shape[0]))]
    prof_sim = _build_sim(pq, mapping, cfg, dcfg, engine, dev,
                          trace=TraceConfig(enabled=True))
    prof_sim.run_batch(prof_batch)
    return profile_summary(
        profile(prof_sim.last_trace(), core_model=prof_sim.core_model,
                riscv=prof_sim.riscv))


def _serving_smoke(sim: ChipSimulator, spikes) -> dict:
    """Push a slice of the eval set through the continuous-batching
    server, so the artifact records what the deployed net looks like *as
    a service*: latency quantiles, throughput, host-DMA cost per request.
    The requests' trains cross to the host in one copy."""
    n_smoke = min(16, int(spikes.shape[0]))
    events = spikes[:n_smoke].cpu().numpy()
    srv = SnnServer(sim, batch_slots=min(8, n_smoke))
    for i in range(n_smoke):
        srv.submit(SnnRequest(uid=i, events=events[i]))
    smoke_done = srv.run()
    lat = srv.metrics.get("snn_request_latency_ms")
    wall_s = max(r.t_complete for r in smoke_done) - min(
        r.t_enqueue for r in smoke_done)
    return {
        "requests": n_smoke,
        "served": int(sum(r.status == SERVED for r in smoke_done)),
        "shed": int(srv.metrics.get("snn_requests_shed_total").value),
        "latency_p50_ms": lat.percentile(0.5),
        "latency_p99_ms": lat.percentile(0.99),
        "throughput_rps": n_smoke / max(wall_s, 1e-9),
        "dma_pj_per_request": float(np.mean(
            [r.dma_pj for r in smoke_done])),
        "model_swap_pj": srv.host_summary()["swap_pj"],
    }


def deploy(cfg: SNNConfig, data, dcfg: DeployConfig | None = None,
           params=None, device=None) -> DeployReport:
    """Train (unless `params` is given), quantize per-core, compile, and
    execute on the chip engine, on `device` (default: the card).  `data`
    is an EventStream-like object with `.batch(batch_size, step,
    device=) -> (spikes, labels)`."""
    dcfg = dcfg or DeployConfig()
    dev = resolve_device(device)
    t = dcfg.train
    log = print if dcfg.verbose else (lambda *a, **k: None)

    # ---- train --------------------------------------------------------
    history: list[dict] = []
    if params is None:
        log(f"== train: {cfg.layer_sizes} x T={cfg.timesteps}, AdamW "
            f"lr={t.lr}, hw={t.hw} ==")
        with torch.profiler.record_function("deploy.train"):
            params, history = SNNTrainer(cfg, t, device=dev).fit(
                lambda step: _batch(data, t.batch, step, dev),
                on_metrics=(lambda s, m: log(
                    f"step {s:4d} loss {m['loss']:.3f} density "
                    f"{m['density']:.3f} rate {m['mean_rate']:.3f}")
                    if t.log_every and s % t.log_every == 0 else None))
    params = [_param(w, dev) for w in params]
    final_loss = history[-1]["loss"] if history else None

    eval_sp, eval_lb = _batch(data, dcfg.eval_batch, dcfg.eval_step, dev)
    acc_train = _accuracy(params, cfg, eval_sp, eval_lb)

    # ---- compile (profile-guided) ------------------------------------
    with torch.profiler.record_function("deploy.compile"):
        compiled = _compile(params, eval_sp[0], cfg, dcfg.mapping_strategy)
    mapping = compiled.to_soc_mapping()
    log(f"== compile: {compiled.summary()} ==")

    # ---- per-core codebook PTQ ---------------------------------------
    prune = (t.hw.l1_weight > 0.0 if dcfg.prune_zero_level is None
             else dcfg.prune_zero_level)
    qcfg = dataclasses.replace(cfg.quant, zero_level=prune)
    with torch.profiler.record_function("deploy.ptq"):
        pq = fit_per_core_codebooks(params, mapping, qcfg, lif=cfg.lif)
    eval_cfg = dataclasses.replace(cfg, qat=False)
    acc_dequant = _accuracy(pq.weights, eval_cfg, eval_sp, eval_lb)
    log(f"== quantize: {pq.n_tables} per-core codebooks (N={qcfg.n_levels} "
        f"x W={qcfg.bit_width}, zero_level={qcfg.zero_level}), rms "
        f"{[round(e, 4) for e in pq.rms_error]} ==")

    # ---- execute on the chip engine ----------------------------------
    engine = dcfg.engine
    if engine == "fused" and cfg.lif.reset_mode != "hard":
        # the fused kernel implements the chip's hard-reset updater only;
        # soft-reset models keep deploying through the compiled engine
        log(f"== engine: reset_mode={cfg.lif.reset_mode!r} not supported "
            f"by the fused kernel — falling back to 'compiled' ==")
        engine = "compiled"
    sim = _build_sim(pq, mapping, cfg, dcfg, engine, dev)
    with torch.profiler.record_function("deploy.chip_eval"):
        _, chip = _chip_eval(sim, eval_sp, eval_lb, dcfg.chip_chunk)
    log(f"== chip: acc {chip['accuracy']:.4f}, {chip['pj_per_sop']:.3f} "
        f"pJ/SOP, sparsity {chip['sparsity']:.3f} ==")

    # ---- chip-side profile (telemetry) -------------------------------
    with torch.profiler.record_function("deploy.profile"):
        chip_profile = _chip_profile(pq, mapping, cfg, dcfg, engine, dev,
                                     eval_sp)

    # ---- serving-SLO smoke (serve tier) ------------------------------
    with torch.profiler.record_function("deploy.serving_smoke"):
        serving_slo = _serving_smoke(sim, eval_sp)
    log(f"== serve smoke: p50 {serving_slo['latency_p50_ms']:.2f} ms, "
        f"p99 {serving_slo['latency_p99_ms']:.2f} ms, "
        f"{serving_slo['throughput_rps']:.1f} req/s ==")

    gates = dcfg.gates.check(acc_train, chip["accuracy"], chip["pj_per_sop"])
    return DeployReport(
        layer_sizes=list(cfg.layer_sizes), timesteps=cfg.timesteps,
        n_levels=qcfg.n_levels, bit_width=qcfg.bit_width, qat=cfg.qat,
        regularized=t.hw.regularized(), train_steps=t.steps,
        eval_samples=int(eval_sp.shape[0]),
        final_loss=(None if final_loss is None else float(final_loss)),
        acc_train=acc_train,
        acc_dequant=acc_dequant, acc_chip=chip["accuracy"],
        quant_rms_error=pq.rms_error,
        sparsity=chip["sparsity"], touch_fraction=chip["touch_fraction"],
        nominal_sops=chip["nominal_sops"],
        performed_sops=chip["performed_sops"],
        pj_per_sop=chip["pj_per_sop"], energy_pj=chip["energy_pj"],
        power_mw=chip["power_mw"], gsops=chip["gsops"],
        wall_cycles=chip["wall_cycles"],
        noc_energy_pj=chip["noc_energy_pj"], noc_hops=chip["noc_hops"],
        n_cores=len(mapping.active_core_ids()),
        n_register_tables=pq.n_tables,
        compile_summary=compiled.summary(), gates=gates,
        chip_profile=chip_profile, serving_slo=serving_slo)
