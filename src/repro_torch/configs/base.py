"""Architecture configuration of the port's decoder paths.

The port's own copy of the fields of the JAX package's `ArchConfig` and
`SSMConfig` (`repro/configs/base.py`) that the ported paths read: shapes
and numerics only. Two families are ported: `dense` (GQA attention and a
SwiGLU FFN in every layer) and `ssm` (a Mamba-2 SSD mixer and no FFN in
every layer). The other families, and the dense options that no ported
model uses yet (qk-norm, qkv bias, MLA, MoE, M-RoPE, int8 KV cache), wait
for the slices that port them. `mtp_depth` is kept so that `loss_fn` can
refuse the MTP loss by name. `ShapeCell` is the reference's (seq_len,
global_batch, kind) cell, which the data pipeline and `train()` read.
"""
from __future__ import annotations

import dataclasses

FAMILIES = ("dense", "ssm")


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256
    n_groups: int = 1


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
    ssm: SSMConfig | None = None
    dtype: str = "bfloat16"              # activation/compute dtype
    param_dtype: str = "float32"
    tie_embeddings: bool = False
    mtp_depth: int = 0                   # DeepSeek MTP (not ported)
    remat: bool = True                   # recompute each layer in backward

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise NotImplementedError(
                f"only the {FAMILIES} families are ported; got "
                f"{self.family!r}")
        if self.family == "ssm":
            if self.ssm is None:
                raise ValueError("the ssm family needs an SSMConfig")
        elif self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def param_count(self) -> int:
        """Parameters of the decoder, from shapes alone, every leaf of the
        tree counted (norm scales, conv bias and dt bias too): the input
        embedding, the output one unless tied, the final norm, and per
        layer its norm(s) and mixer (and FFN for the dense family)."""
        d = self.d_model
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            H = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            layer = (d + d * (d_in + conv_dim + H)        # ln1, in_proj
                     + (s.conv_kernel + 1) * conv_dim     # conv_w, conv_b
                     + 3 * H + d_in + d_in * d)           # A, D, dt; norm; out
        else:
            dh = self.dh
            attn = (d * self.num_heads * dh * 2
                    + 2 * d * self.num_kv_heads * dh)
            layer = attn + 3 * d * self.d_ff + 2 * d
        tables = 1 if self.tie_embeddings else 2
        return tables * self.vocab_size * d + self.num_layers * layer + d


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
