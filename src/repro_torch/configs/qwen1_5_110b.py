"""qwen1.5-110b: 80L d=8192 64H (GQA kv=8, head_dim 128) d_ff=49152 vocab
152064, qkv bias, as the JAX package's `repro/configs/qwen1_5_110b.py`."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=49152, vocab_size=152064, qkv_bias=True,
)
