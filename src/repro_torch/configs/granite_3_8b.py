"""granite-3-8b — dense GQA transformer.
[hf:ibm-granite/granite-3.0-2b-base family; hf]"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155,
)

SMOKE = ArchConfig(
    name="granite-3-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
)
