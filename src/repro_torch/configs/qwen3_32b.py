"""qwen3-32b: 64L d=5120 64H (GQA kv=8, head_dim 128) d_ff=25600 vocab
151936, qk-norm, as the JAX package's `repro/configs/qwen3_32b.py`."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=25600, vocab_size=151936, qk_norm=True,
)
