"""deepseek-v3-671b [arXiv:2412.19437]: 61L d=7168 128H, MLA, MoE 256
routed top-8 + 1 shared (per-expert d_ff=2048), vocab 129280, MTP depth 1,
as the JAX package's `repro/configs/deepseek_v3_671b.py`.

The reference's simplification is kept: all 61 layers are MoE (the
release keeps the first 3 dense), so the layer stack is homogeneous.
The MTP head (`mtp_depth=1`: a projection, two norms and one more MoE
layer) is in the tree and in `param_count()`; the training loss reads it,
the serving path does not.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=2048, vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert_ff=2048, num_shared=1),
    mtp_depth=1,
)
