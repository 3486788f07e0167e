"""whisper-large-v3: encoder-decoder, 32 + 32 layers, d=1280, 20 heads,
d_ff=5120, vocab 51866, tied embeddings, as the JAX package's
`repro/configs/whisper_large_v3.py`. The conv frontend is stubbed: the
encoder takes (B, 1500, d) frame embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    num_layers=32, encoder_layers=32, encoder_seq=1500,
    d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, tie_embeddings=True,
)
