"""stablelm-3b: 32L d=2560 32H (kv=32) d_ff=6912 vocab 50304, as the JAX
package's `repro/configs/stablelm_3b.py` (full RoPE, untied embeddings)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304,
)
