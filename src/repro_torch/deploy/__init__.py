"""repro_torch.deploy — the hardware-aware training→deploy pipeline, in
torch.  Port of `repro.deploy`.

    deploy(cfg, data) ->
        train     (train.snn_trainer: BPTT + spike-rate/L1/QAT hw losses)
        quantize  (per-core codebook PTQ -> RegisterTables)
        compile   (repro_torch.compiler partition -> place -> route)
        execute   (core.engine.FusedEngine, batched)
    -> DeployReport with accuracy/energy parity gates

and `continual_adaptation`, the drift-and-recover scenario of on-chip
R-STDP.  Both run on the card unless `device="cpu"` is passed.  See
examples/torch_train_deploy_nmnist.py for the runnable walkthrough.
"""
from repro_torch.deploy.adapt import (AdaptConfig, AdaptReport,
                                      continual_adaptation)
from repro_torch.deploy.pipeline import DeployConfig, deploy
from repro_torch.deploy.quantize import PerCoreQuant, fit_per_core_codebooks
from repro_torch.deploy.report import DeployReport, ParityGates

__all__ = [
    "AdaptConfig", "AdaptReport", "DeployConfig", "DeployReport",
    "ParityGates", "PerCoreQuant", "continual_adaptation", "deploy",
    "fit_per_core_codebooks",
]
