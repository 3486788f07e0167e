"""granite-20b: 52L d=6144 48H MQA (kv=1) d_ff=24576 vocab 49152,
llama-style blocks, as the JAX package's `repro/configs/granite_20b.py`."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152,
)
