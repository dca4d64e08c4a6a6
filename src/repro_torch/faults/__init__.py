"""repro_torch.faults — deterministic, seeded fault injection + tolerance.

Port of `repro.faults`.  The subsystem has two halves:

* `faults.model` — the `FaultConfig` describing a faulty chip (dead
  cores, failed level-1/level-2 routers and links, stuck-at / bit-flip
  corruption of `RegisterTable` codebook words, per-hop spike-packet
  drop probability, injected transient dispatch faults) plus the
  lowering helpers that fold it into `ChipSimulator` state: static
  weight masks for topology faults, corrupted register tables, and the
  seeded per-timestep `DropPlan` both engines replay — the reference's
  `jax.random` masks bit for bit (`faults/_threefry.py`).
* `faults.survivability` — masked-graph survivability studies (routable
  pairs + sustained injection rate under k random router kills),
  fullerene vs the equal-node mesh.

Every random choice derives from `numpy.random.SeedSequence` seeds — no
global RNG anywhere, so a `FaultConfig` is a value: the same config +
seed produces the same faulty chip in every engine and every process.
A fault-free config is zero-cost: the engines issue the same torch ops
with and without it (tests/test_torch_faults.py counts them).
"""
from repro_torch.faults.model import (CodebookFault, DropPlan, FaultConfig,
                                      NULL_FAULTS, TransientChipFault,
                                      apply_chip_faults, build_drop_plan,
                                      derive_fault_seed, masked_adjacency,
                                      sample_faults)
from repro_torch.faults.survivability import (routable_fraction,
                                              masked_saturation_rate,
                                              survivability_study)

__all__ = [
    "CodebookFault", "DropPlan", "FaultConfig", "NULL_FAULTS",
    "TransientChipFault", "apply_chip_faults", "build_drop_plan",
    "derive_fault_seed", "masked_adjacency", "masked_saturation_rate",
    "routable_fraction", "sample_faults", "survivability_study",
]
