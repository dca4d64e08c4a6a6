"""whisper-tiny — enc-dec backbone; conv/mel frontend is a STUB
(input_specs provides precomputed frame embeddings (B, 1500, d)).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, enc_layers=4, enc_frames=1500,
)

SMOKE = ArchConfig(
    name="whisper-tiny-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, enc_layers=2, enc_frames=16,
)
