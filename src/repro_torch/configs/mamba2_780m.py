"""mamba2-780m: 48L d=1536 attention-free SSD, d_state 128, head_dim 64,
expand 2, chunk 256, vocab 50280, tied embeddings, marked for long
contexts (its state is O(1) in the sequence), as the JAX package's
`repro/configs/mamba2_780m.py`."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=48, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                  chunk=256, n_groups=1),
    long_context_ok=True, tie_embeddings=True,
)
