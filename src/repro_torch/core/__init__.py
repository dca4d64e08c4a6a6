"""Core library of the port: the paper's contributions in torch/numpy.

C1  zero-skip sparse spike processing      -> repro_torch.core.zspe
C2  partial membrane-potential update      -> repro_torch.core.neuron
C3  non-uniform codebook quantization      -> repro_torch.core.quant
C4  fullerene-like NoC                     -> repro_torch.core.noc
C5  heterogeneous SoC                      -> repro_torch.core.soc
calibrated 55nm energy model               -> repro_torch.core.energy

Import the modules directly; this package imports none of them.
"""
