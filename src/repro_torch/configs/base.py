"""Architecture configuration of the port's decoder paths.

The port's own copy of the fields of the JAX package's `ArchConfig` and
`SSMConfig` (`repro/configs/base.py`) that the ported paths read: shapes
and numerics only, under the reference's names and defaults. Four
families are ported: `dense` (GQA or MQA attention and a SwiGLU FFN in
every layer, with the qk-norm, qkv-bias and int8 KV-cache options),
`moe` (the dense stack with a mixture-of-experts FFN, `MoEConfig`, in
every layer), `ssm` (a Mamba-2 SSD mixer and no FFN in
every layer), `encdec` (the Whisper-style encoder-decoder of
`models/encdec.py`) and `vlm` (the dense stack with M-RoPE over vision
embeddings and text). Any decoder family may take DeepSeek's multi-head
latent attention (`MLAConfig`) in place of GQA. `hybrid` is refused by
name; `mtp_depth` is kept so that the training path can name what it
refuses. `ShapeCell` is the reference's (seq_len, global_batch, kind)
cell, which the data pipeline and `train()` read.
"""
from __future__ import annotations

import dataclasses

FAMILIES = ("dense", "moe", "ssm", "encdec", "vlm")
# Families of the reference that wait for a slice of their own.
_UNPORTED = {"hybrid": "ROADMAP item 12e"}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert_ff: int            # per-expert hidden width
    num_shared: int = 0         # shared (always-on) experts
    layer_period: int = 1       # MoE every Nth layer (1 = every layer)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    dispatch: str = "einsum"    # "einsum" (GShard one-hot) | "scatter"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


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
    mla: MLAConfig | None = None         # deepseek-v3
    moe: MoEConfig | None = None         # mixture-of-experts FFN
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
        if self.moe is not None and self.moe.layer_period != 1:
            # The reference's decoder stack is homogeneous; only its hybrid
            # family interleaves MoE and dense FFNs.
            raise NotImplementedError(
                "an MoE layer_period other than 1 belongs to the hybrid "
                "family (ROADMAP item 12e)")
        if self.mrope_sections is not None and \
                2 * sum(self.mrope_sections) != self.dh:
            raise ValueError(f"mrope_sections {self.mrope_sections} must "
                             f"split the rotary half-width {self.dh // 2}")
        if self.family == "ssm":
            if self.ssm is None:
                raise ValueError("the ssm family needs an SSMConfig")
        elif self.mla is None and self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def _attn_params(self, self_attn: bool = True) -> int:
        """One attention block: q, k, v and o, and for self-attention the
        qkv biases and the qk-norm scales where configured (the
        encoder-decoder's cross-attention has neither); with MLA its
        seven projections and its two norms."""
        d, H, KV, dh = (self.d_model, self.num_heads, self.num_kv_heads,
                        self.dh)
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank        # wdq, q_norm
                    + m.q_lora_rank * H * qk                 # wuq
                    + d * m.kv_lora_rank + m.kv_lora_rank    # wdkv, kv_norm
                    + d * m.qk_rope_head_dim                 # wkr
                    + m.kv_lora_rank * H * (m.qk_nope_head_dim
                                            + m.v_head_dim)  # wuk, wuv
                    + H * m.v_head_dim * d)                  # wo
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
            if self.moe is not None:
                e = self.moe
                ffn = (d * e.num_experts + (e.num_experts + e.num_shared)
                       * 3 * d * e.d_expert_ff)
            layer = self._attn_params() + ffn + 2 * d
        return tables * self.vocab_size * d + self.num_layers * layer + d


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
