"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (GQA kv=4,
head_dim 128), MoE 128 experts top-8, per-expert d_ff=768, vocab 151936,
qk-norm, as the JAX package's `repro/configs/qwen3_moe_30b_a3b.py`."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=768, vocab_size=151936, qk_norm=True,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert_ff=768),
)
