"""Core library of the port: the paper's contributions in torch/numpy.

C1  zero-skip sparse spike processing      -> repro_torch.core.zspe
C2  partial membrane-potential update      -> repro_torch.core.neuron
C3  non-uniform codebook quantization      -> repro_torch.core.quant
C4  fullerene-like NoC                     -> repro_torch.core.noc
C5  heterogeneous SoC                      -> repro_torch.core.soc
calibrated 55nm energy model               -> repro_torch.core.energy
on-chip learning (STDP, R-STDP)            -> repro_torch.core.plasticity

Import the modules directly; this package exports only the plasticity
config (`PlasticityConfig`, `NULL_PLASTICITY`) and, as `repro.core`
does, `neuron.run_timesteps`.
"""
from repro_torch.core.neuron import run_timesteps
from repro_torch.core.plasticity import NULL_PLASTICITY, PlasticityConfig

__all__ = ["NULL_PLASTICITY", "PlasticityConfig", "run_timesteps"]
