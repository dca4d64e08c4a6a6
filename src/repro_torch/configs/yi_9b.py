"""yi-9b — llama-arch GQA. [arXiv:2403.04652; hf]"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000,
)

SMOKE = ArchConfig(
    name="yi-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
)
