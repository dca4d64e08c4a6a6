"""Roofline terms of one traced step, per device.

Port of `repro.distributed.roofline`.  Terms (per device; a traced step
counts one device's local work, `distributed/trace_analysis.py`):
    compute    = FLOPs / peak FLOP/s           [s]
    memory     = HBM bytes / HBM bandwidth      [s]
    collective = collective bytes / link rate   [s]

The constants are the port's card's, NVIDIA H100 SXM (80 GB HBM3), not
the reference's TPU v5e: bf16 dense tensor-core peak 989e12 FLOP/s, HBM3
3.35e12 B/s, and one NVLink 4 figure for the collective term, 450e9 B/s
per direction (18 links of 25 GB/s each way, 900 GB/s both ways, per
NVIDIA's H100 SXM datasheet).  The dry run's numbers built on them are
analytic, not measured.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM 80GB (per device)
PEAK_FLOPS_BF16 = 989e12         # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                 # B/s, HBM3
LINK_BW = 450e9                  # B/s, NVLink 4, one direction


@dataclasses.dataclass
class RooflineReport:
    name: str
    flops: float                 # per-device traced flops
    bytes_accessed: float        # per-device traced HBM bytes
    coll_bytes: float            # per-device collective bytes
    model_flops: float           # 6*N*D (or 2*N*D decode) global
    chips: int
    per_kind: dict
    op_counts: dict

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (traced flops x chips) — recompute / redundancy
        waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step ran at
        the bound of its slowest term: (model_flops/chips/peak) /
        t_bound."""
        ideal = self.model_flops / self.chips / PEAK_FLOPS_BF16
        return ideal / self.t_bound if self.t_bound else 0.0

    def row(self) -> dict:
        return {
            "name": self.name,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops": self.flops,
            "hlo_bytes": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_ops": self.op_counts,
        }


def analyze_trace(name: str, costs, model_flops: float,
                  chips: int) -> RooflineReport:
    """All three terms from a traced step's counts
    (`trace_analysis.TraceCosts`); the row keeps the reference's keys
    (`hlo_flops`, `hlo_bytes`) for the traced counts."""
    return RooflineReport(
        name=name, flops=costs.flops, bytes_accessed=costs.hbm_bytes,
        coll_bytes=costs.coll_bytes, model_flops=model_flops, chips=chips,
        per_kind=costs.per_kind, op_counts=costs.op_counts)


def model_flops_for(cfg, shape) -> float:
    """6*N_active*D for train; 2*N_active per generated token for decode;
    2*N_active*D for prefill."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence + attention reads over the cache
    tokens = shape.global_batch
    flops = 2.0 * n * tokens
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        # KV dot products: 2 * 2 * kv*hd * S per layer per sequence
        eff_s = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        flops += (4.0 * cfg.n_layers * cfg.n_kv_heads * cfg.hd
                  * eff_s * tokens)
    return flops
