"""The paper's own configuration: 20-core neuromorphic chip SNN.
This is the config the ChipSimulator + SNN examples use (160 K LIF
neurons max, per-core N x W codebooks)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SNNChipConfig:
    layer_sizes: tuple = (2312, 4096, 1024, 10)   # NMNIST-like MLP
    timesteps: int = 20
    threshold: float = 1.0
    leak: float = 0.9
    weight_levels: int = 16       # N
    weight_bits: int = 8          # W
    freq_hz: float = 100e6


ARCH = SNNChipConfig()
SMOKE = SNNChipConfig(layer_sizes=(64, 128, 10), timesteps=4)
