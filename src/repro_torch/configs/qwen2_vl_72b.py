"""qwen2-vl-72b: 80L d=8192 64H (GQA kv=8, head_dim 128) d_ff=29568 vocab
152064, M-RoPE over (t, h, w) sections (16, 24, 24), qkv bias, a quarter
of the sequence vision-patch embeddings, as the JAX package's
`repro/configs/qwen2_vl_72b.py`. The vision frontend is stubbed: the
model takes patch embeddings and 3-component position ids."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=29568, vocab_size=152064, qkv_bias=True,
    mrope_sections=(16, 24, 24), vision_tokens_frac=0.25,
)
