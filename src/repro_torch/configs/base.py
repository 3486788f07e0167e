"""Architecture configuration of the port's dense decoder path.

The port's own copy of the fields of the JAX package's `ArchConfig`
(`repro/configs/base.py`) that the dense path reads: shapes and numerics
only. Families other than `dense`, and the dense options that no ported
model uses yet (qk-norm, qkv bias, MLA, MoE, M-RoPE, int8 KV cache), wait
for the slices that port them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // num_heads
    rope_theta: float = 1e6
    dtype: str = "bfloat16"              # activation/compute dtype
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.family != "dense":
            raise NotImplementedError(
                f"only the dense family is ported; got {self.family!r}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def param_count(self) -> int:
        """Parameters of the dense decoder, from shapes alone: the input and
        output embeddings (untied in every ported model), per layer q/k/v/o,
        SwiGLU and two norm scales, and the final norm."""
        d, dh = self.d_model, self.dh
        attn = d * self.num_heads * dh * 2 + 2 * d * self.num_kv_heads * dh
        layer = attn + 3 * d * self.d_ff + 2 * d
        return 2 * self.vocab_size * d + self.num_layers * layer + d
