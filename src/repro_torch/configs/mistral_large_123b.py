"""mistral-large-123b — dense GQA transformer.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab=32768,
)

SMOKE = ArchConfig(
    name="mistral-large-123b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192, vocab=256,
)
