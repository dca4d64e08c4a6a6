"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, n_experts=64, top_k=6,
    moe_group_size=256,
)

SMOKE = ArchConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=256, n_experts=4, top_k=2, moe_group_size=64,
)
