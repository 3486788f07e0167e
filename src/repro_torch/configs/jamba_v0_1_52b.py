"""jamba-v0.1-52b [arXiv:2403.19887]: 32L d=4096, Mamba:attn 7:1
(attention at offset 4 of each 8-layer block, GQA 32 heads over 8 kv
heads of 128), MoE 16 experts top-2 every other layer (the odd ones),
d_ff 14336, vocab 65536, as the JAX package's
`repro/configs/jamba_v0_1_52b.py`. Jamba's Mamba-1 blocks are Mamba-2
(SSD) blocks there, and so here: d_in 8192, 128 heads of 64, state 64.
Marked for long contexts: KV lives in 4 of its 32 layers."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=65536,
    attn_layer_period=8, attn_layer_offset=4,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert_ff=14336, layer_period=2),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk=256, n_groups=1),
    long_context_ok=True,
)
