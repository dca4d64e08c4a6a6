"""granite-moe-1b-a400m — IBM granite 3.0 1b-a400m, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155, n_experts=32, top_k=8,
    moe_group_size=256,   # smaller dispatch groups
)

SMOKE = ArchConfig(
    name="granite-moe-1b-a400m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=256, n_experts=4, top_k=2, moe_group_size=64,
)
