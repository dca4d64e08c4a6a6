"""zamba2-2.7b — Mamba2 backbone + one shared attention block every 6
layers; sliding-window attention gives the sub-quadratic long_500k path.
[arXiv:2411.15242; hf]"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, ssm_state=64, attn_every=6,
    sliding_window=4096,
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, ssm_state=16, ssm_head_dim=32, ssm_chunk=8,
    attn_every=2, sliding_window=16,
)
