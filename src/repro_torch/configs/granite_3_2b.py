"""granite-3-2b — dense GQA transformer (head_dim 64).
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155,
)

SMOKE = ArchConfig(
    name="granite-3-2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
)
