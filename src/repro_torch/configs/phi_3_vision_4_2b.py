"""phi-3-vision-4.2b — phi3-mini backbone; CLIP patch frontend is a STUB
(the caller provides precomputed patch embeddings (B, 576, d)).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, n_patches=576,
)

SMOKE = ArchConfig(
    name="phi-3-vision-4.2b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, n_patches=8,
)
