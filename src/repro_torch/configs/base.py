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
embeddings and text) and `hybrid` (Jamba: a Mamba-2 mixer in every
layer but one of each `attn_layer_period`, at `attn_layer_offset`, which
is GQA attention, and an MoE FFN in every `moe.layer_period`-th layer,
the last of each period, a SwiGLU in the others). Any decoder family but
the hybrid may take DeepSeek's multi-head latent attention (`MLAConfig`)
in place of GQA. `mtp_depth` gives the model DeepSeek-V3's
multi-token-prediction head, which the training loss reads and serving
does not. `ShapeCell` is the reference's (seq_len, global_batch,
kind) cell, which the data pipeline, `train()` and
`launch/analytics.py` read; `SHAPES` are the reference's four cells.
"""
from __future__ import annotations

import dataclasses
import math

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


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
    attn_layer_period: int = 0           # hybrid: every Nth layer is attn
    attn_layer_offset: int = 4           # hybrid: offset within period
    encoder_layers: int = 0              # encoder-decoder
    encoder_seq: int = 1500              # whisper frame positions
    vision_tokens_frac: float = 0.25     # vlm: share of seq that is patches
    mtp_depth: int = 0                   # DeepSeek MTP head (training)
    dtype: str = "bfloat16"              # activation/compute dtype
    param_dtype: str = "float32"
    kv_quant: bool = False               # int8 KV cache (serving)
    remat: bool = True                   # recompute each layer in backward
    long_context_ok: bool = False        # can run long_500k decode
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; ported: "
                             f"{FAMILIES}")
        if self.moe is not None and self.moe.layer_period != 1 \
                and self.family != "hybrid":
            # The reference stacks a non-hybrid decoder's layers into one
            # array per leaf, which mixed layers cannot be; only its
            # hybrid family interleaves MoE and dense FFNs.
            raise NotImplementedError(
                f"an MoE layer_period other than 1 in the {self.family!r} "
                "family: the reference interleaves MoE and dense FFNs in "
                "the hybrid family only")
        if self.mrope_sections is not None and \
                2 * sum(self.mrope_sections) != self.dh:
            raise ValueError(f"mrope_sections {self.mrope_sections} must "
                             f"split the rotary half-width {self.dh // 2}")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"the {self.family} family needs an SSMConfig")
        if self.family == "hybrid":
            if self.mla is not None:
                raise ValueError("the hybrid family's attention is GQA")
            if self.num_layers % self.block_group_size():
                # The reference would drop the layers past the last group.
                raise ValueError(
                    f"a hybrid stack of {self.num_layers} layers is no "
                    f"whole number of {self.block_group_size()}-layer "
                    "groups")
        if self.family != "ssm" and self.mla is None \
                and self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def layer_kind(self, layer: int) -> tuple[str, str]:
        """-> (mixer, ffn) of a decoder layer, as the reference's
        `transformer.layer_kind`: mixer `attn` (GQA), `mla` or `ssm`; ffn
        `dense` (SwiGLU), `moe` or `none`."""
        if self.family == "ssm":
            return "ssm", "none"
        if self.family == "hybrid":
            period = self.attn_layer_period
            mixer = ("attn" if period and layer % period
                     == self.attn_layer_offset else "ssm")
            ffn = ("moe" if self.moe is not None and layer
                   % self.moe.layer_period == self.moe.layer_period - 1
                   else "dense")
            return mixer, ffn
        return ("mla" if self.mla is not None else "attn",
                "moe" if self.moe is not None else "dense")

    def block_group_size(self) -> int:
        """Layers of one group of the parameter tree, as the reference's
        `transformer.block_group_size`: the hybrid's repeating pattern,
        the lcm of its attention and MoE periods; 1 otherwise."""
        if self.family != "hybrid":
            return 1
        period = self.attn_layer_period or 1
        if self.moe is not None:
            period = math.lcm(period, self.moe.layer_period)
        return period

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

    def _ssm_params(self) -> int:
        """One Mamba-2 mixer: in_proj, conv weight and bias, A_log, D and
        dt_bias, the gated norm, out_proj."""
        s, d = self.ssm, self.d_model
        d_in = s.expand * d
        H = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        return (d * (d_in + conv_dim + H) + (s.conv_kernel + 1) * conv_dim
                + 3 * H + d_in + d_in * d)

    def _expert_params(self) -> int:
        return 3 * self.d_model * self.moe.d_expert_ff

    def _layer_params(self, layer: int) -> int:
        """A decoder layer: ln1 and its mixer, and where it has an FFN,
        ln2 and the FFN (the router, routed and shared experts of an MoE
        one)."""
        d = self.d_model
        mixer, ffn = self.layer_kind(layer)
        n = d + (self._ssm_params() if mixer == "ssm"
                 else self._attn_params())
        if ffn == "moe":
            e = self.moe
            n += (d + d * e.num_experts
                  + (e.num_experts + e.num_shared) * self._expert_params())
        elif ffn == "dense":
            n += d + 3 * d * self.d_ff
        return n

    def mtp_param_count(self) -> int:
        """The MTP head, where the model has one: its projection from 2d
        to d, its two norms and one layer of the last layer's kind."""
        if not self.mtp_depth:
            return 0
        d = self.d_model
        return 2 * d * d + 2 * d + self._layer_params(self.num_layers - 1)

    def param_count(self) -> int:
        """Parameters of the model, from shapes alone, every leaf of the
        tree counted (norm scales, biases, conv bias and dt bias too): the
        input embedding, the output one unless tied, the final norm(s),
        per layer its norms, mixer and FFN, each layer by its kind, and
        the MTP head where the model has one; for the encoder-decoder the
        encoder blocks, `enc_ln`, and each decoder block's `lnx` and
        cross-attention."""
        d = self.d_model
        tables = (1 if self.tie_embeddings else 2) * self.vocab_size * d
        if self.family == "encdec":
            ffn = 3 * d * self.d_ff
            enc = self._attn_params() + ffn + 2 * d
            dec = self._attn_params() + self._attn_params(False) + ffn + 3 * d
            return (tables + self.encoder_layers * enc
                    + self.num_layers * dec + 2 * d)
        return tables + sum(self._layer_params(i)
                            for i in range(self.num_layers)) + d \
            + self.mtp_param_count()

    def active_param_count(self) -> int:
        """Parameters one token meets in the forward: all but the MTP head
        (which only the training loss reads; DeepSeek-V3 quotes its active
        count so) and the num_experts - top_k routed experts it skips in
        each MoE layer."""
        n = self.param_count() - self.mtp_param_count()
        if self.moe is None:
            return n
        moe_layers = sum(self.layer_kind(i)[1] == "moe"
                         for i in range(self.num_layers))
        skipped = self.moe.num_experts - self.moe.top_k
        return n - moe_layers * skipped * self._expert_params()


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    """The `SHAPES` cell called `name`; `KeyError` for any other."""
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
