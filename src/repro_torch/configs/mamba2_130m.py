"""mamba2-130m — attention-free SSD (state-space duality).
24 SSD heads (headdim 64).
[arXiv:2405.21060; unverified]"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128,
)

SMOKE = ArchConfig(
    name="mamba2-130m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=256, ssm_state=16, ssm_head_dim=32, ssm_chunk=8,
)
