"""DeployReport — the single artifact a train→deploy run produces.
Port of `repro.deploy.report`.

Collects the trained-model metrics, the quantization cost, the compile
summary and the chip-execution accounting into one serializable record,
and evaluates the two parity gates:

  * **accuracy gate** — chip-engine accuracy within `accuracy_tol`
    (absolute) of the trained model's accuracy;
  * **energy gate** — chip pJ/SOP within `pj_margin`× of the paper's
    0.96 pJ/SOP NMNIST anchor (the achievable figure depends on the
    workload's spike sparsity; the margin bounds how far the deployed
    network may sit from the paper's operating point).

Every field holds plain Python numbers, lists and dicts (the pipeline
crosses each device value to the host once), so `to_dict()` is JSON as
it stands.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core import energy as E


@dataclasses.dataclass(frozen=True)
class ParityGates:
    accuracy_tol: float = 0.01          # absolute accuracy delta, chip vs model
    pj_per_sop_target: float = E.ANCHOR_CHIP_PJ_NMNIST   # 0.96
    pj_margin: float = 1.35             # pass while pj <= target * margin

    def check(self, acc_train: float, acc_chip: float,
              pj_per_sop: float) -> dict:
        acc_ok = abs(acc_train - acc_chip) <= self.accuracy_tol
        pj_ok = pj_per_sop <= self.pj_per_sop_target * self.pj_margin
        return {
            "accuracy_parity_ok": bool(acc_ok),
            "accuracy_delta": float(abs(acc_train - acc_chip)),
            "accuracy_tol": self.accuracy_tol,
            "energy_ok": bool(pj_ok),
            "pj_per_sop": float(pj_per_sop),
            "pj_per_sop_target": self.pj_per_sop_target,
            "pj_vs_target": float(pj_per_sop / self.pj_per_sop_target),
            "pj_margin": self.pj_margin,
            "passed": bool(acc_ok and pj_ok),
        }


@dataclasses.dataclass
class DeployReport:
    """Everything `deploy.deploy()` learned, JSON-serializable."""

    # network / run identity
    layer_sizes: list
    timesteps: int
    n_levels: int
    bit_width: int
    qat: bool
    regularized: bool
    train_steps: int
    eval_samples: int

    # training
    final_loss: float | None      # None when deploy() got pretrained params
    acc_train: float          # trained model (QAT forward if qat)
    acc_dequant: float        # model forward over the chip's register weights
    acc_chip: float           # chip engine on the mapped chip
    quant_rms_error: list

    # workload statistics the energy model prices
    sparsity: float           # ZSPE skip rate (zero-spike fraction)
    touch_fraction: float     # partial-update fraction (touched neurons)
    nominal_sops: float
    performed_sops: float

    # chip accounting
    pj_per_sop: float
    energy_pj: float
    power_mw: float
    gsops: float
    wall_cycles: float
    noc_energy_pj: float
    noc_hops: float
    n_cores: int
    n_register_tables: int
    compile_summary: dict

    # gates
    gates: dict

    # chip-side profile of the deployed network (telemetry.profile_summary
    # over a traced eval batch): per-layer/per-core energy+cycle hotspots
    # embedded so the artifact answers "where do the pJ go" by itself.
    # Optional + last so reports without it still load.
    chip_profile: dict | None = None

    # serving-SLO smoke: the deployed net pushed through the
    # continuous-batching SnnServer — latency p50/p99, throughput,
    # host-DMA cost per request.  Optional + trailing, same reasoning.
    serving_slo: dict | None = None

    @property
    def passed(self) -> bool:
        return bool(self.gates.get("passed", False))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    def summary(self) -> str:
        g = self.gates
        lines = [
            f"net {tuple(self.layer_sizes)}  T={self.timesteps}  "
            f"codebook N={self.n_levels} x W={self.bit_width}-bit  "
            f"qat={self.qat} regularized={self.regularized}",
            f"accuracy   train {self.acc_train:.4f} | dequant "
            f"{self.acc_dequant:.4f} | chip {self.acc_chip:.4f}  "
            f"(gate: |Δ| {g['accuracy_delta']:.4f} <= {g['accuracy_tol']}: "
            f"{'PASS' if g['accuracy_parity_ok'] else 'FAIL'})",
            f"sparsity   zspe-skip {self.sparsity:.3f}  "
            f"partial-update touch {self.touch_fraction:.3f}",
            f"energy     {self.pj_per_sop:.3f} pJ/SOP vs paper "
            f"{g['pj_per_sop_target']} ({g['pj_vs_target']:.2f}x; gate <= "
            f"{g['pj_margin']}x: {'PASS' if g['energy_ok'] else 'FAIL'})",
            f"chip       {self.power_mw:.2f} mW  {self.gsops:.3f} GSOP/s  "
            f"{self.n_cores} cores  {self.n_register_tables} register tables",
            f"overall    {'PASS' if self.passed else 'FAIL'}",
        ]
        if self.serving_slo:
            s = self.serving_slo
            lines.insert(-1, (
                f"serving    p50 {s['latency_p50_ms']:.2f} ms  p99 "
                f"{s['latency_p99_ms']:.2f} ms  "
                f"{s['throughput_rps']:.1f} req/s  dma "
                f"{s['dma_pj_per_request']:.0f} pJ/req"))
        return "\n".join(lines)
