"""Architecture configuration of the port's decoder paths.

The port's own copy of the fields of the JAX package's `ArchConfig` and
`SSMConfig` (`repro/configs/base.py`) that the ported paths read: shapes
and numerics only, under the reference's names and defaults. Four
families are ported: `dense` (GQA or MQA attention and a SwiGLU FFN in
every layer, with the qk-norm, qkv-bias and int8 KV-cache options),
`ssm` (a Mamba-2 SSD mixer and no FFN in every layer), `encdec` (the
Whisper-style encoder-decoder of `models/encdec.py`) and `vlm` (the dense
stack with M-RoPE over vision embeddings and text). `moe` and `hybrid`,
and an MLA config, are refused by name. `mla`, `moe` and `mtp_depth` are
kept so that the refusals can name what they refuse. `ShapeCell` is the
reference's (seq_len, global_batch, kind) cell, which the data pipeline
and `train()` read.
"""
from __future__ import annotations

import dataclasses

FAMILIES = ("dense", "ssm", "encdec", "vlm")
# Families of the reference that wait for a slice of their own.
_UNPORTED = {"moe": "ROADMAP item 12d", "hybrid": "ROADMAP item 12e"}


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
    qk_norm: bool = False                # qwen3 family
    qkv_bias: bool = False               # qwen1.5 / qwen2 family
    rope_theta: float = 1e6
    mrope_sections: tuple[int, int, int] | None = None   # qwen2-vl (t,h,w)
    mla: object | None = None            # DeepSeek MLA (not ported)
    moe: object | None = None            # mixture of experts (not ported)
    ssm: SSMConfig | None = None
    encoder_layers: int = 0              # encoder-decoder
    encoder_seq: int = 1500              # whisper frame positions
    vision_tokens_frac: float = 0.25     # vlm: share of seq that is patches
    mtp_depth: int = 0                   # DeepSeek MTP (not ported)
    dtype: str = "bfloat16"              # activation/compute dtype
    param_dtype: str = "float32"
    kv_quant: bool = False               # int8 KV cache (serving)
    remat: bool = True                   # recompute each layer in backward
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.family in _UNPORTED:
            raise NotImplementedError(
                f"the {self.family!r} family is not ported "
                f"({_UNPORTED[self.family]})")
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; ported: "
                             f"{FAMILIES}")
        if self.mla is not None:
            raise NotImplementedError(
                "multi-head latent attention is not ported (ROADMAP item "
                "12d)")
        if self.moe is not None:
            raise NotImplementedError(
                "mixture-of-experts layers are not ported (ROADMAP item "
                "12d)")
        if self.mrope_sections is not None and \
                2 * sum(self.mrope_sections) != self.dh:
            raise ValueError(f"mrope_sections {self.mrope_sections} must "
                             f"split the rotary half-width {self.dh // 2}")
        if self.family == "ssm":
            if self.ssm is None:
                raise ValueError("the ssm family needs an SSMConfig")
        elif self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def _attn_params(self, self_attn: bool = True) -> int:
        """One attention block: q, k, v and o, and for self-attention the
        qkv biases and the qk-norm scales where configured (the
        encoder-decoder's cross-attention has neither)."""
        d, H, KV, dh = (self.d_model, self.num_heads, self.num_kv_heads,
                        self.dh)
        n = 2 * d * H * dh + 2 * d * KV * dh
        if self_attn and self.qkv_bias:
            n += H * dh + 2 * KV * dh
        if self_attn and self.qk_norm:
            n += 2 * dh
        return n

    def param_count(self) -> int:
        """Parameters of the model, from shapes alone, every leaf of the
        tree counted (norm scales, biases, conv bias and dt bias too): the
        input embedding, the output one unless tied, the final norm(s),
        and per layer its norms, mixer and FFN; for the encoder-decoder
        the encoder blocks, `enc_ln`, and each decoder block's `lnx` and
        cross-attention."""
        d = self.d_model
        ffn = 3 * d * self.d_ff
        tables = 1 if self.tie_embeddings else 2
        if self.family == "encdec":
            enc = self._attn_params() + ffn + 2 * d
            dec = self._attn_params() + self._attn_params(False) + ffn + 3 * d
            return (tables * self.vocab_size * d + self.encoder_layers * enc
                    + self.num_layers * dec + 2 * d)
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            H = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            layer = (d + d * (d_in + conv_dim + H)        # ln1, in_proj
                     + (s.conv_kernel + 1) * conv_dim     # conv_w, conv_b
                     + 3 * H + d_in + d_in * d)           # A, D, dt; norm; out
        else:
            layer = self._attn_params() + ffn + 2 * d
        return tables * self.vocab_size * d + self.num_layers * layer + d


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
