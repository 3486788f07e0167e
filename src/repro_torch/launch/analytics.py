"""Analytic FLOPs and HBM bytes per (arch x shape) cell: the port of
`repro/launch/analytics.py`.

Shape arithmetic alone: exact matrix-product dims summed over the real
schedule, from the config. No tensor is made; a test that ties a count
to the parameter tree builds it with `init_params(cfg, device="meta")`.
Each layer is counted by its kind (`ArchConfig.layer_kind`): GQA or MLA
attention, a Mamba-2 mixer, a dense or MoE FFN.

FLOP conventions: a matmul (m, k) @ (k, n) is 2mkn. Training is the
forward, twice it for the backward, and once more under full remat: 4x
the forward. Prefill and training count each token against the causal
average context S / 2; decode counts one new token a sequence against an
S-token cache.

Bytes (per device, for the given chip count): the parameters read once a
pass (and the optimizer's read and write of parameters and moments when
training), about c reads and writes of each layer boundary's
activations, and for decode the whole KV cache (the SSM state in a
Mamba-2 layer). Parameter bytes come from the port's exact
`param_count()`, where the reference's is approximate (ROADMAP B6), less
the MTP head outside training (`params_read`), so
`cell_hbm_bytes`, `analytic_record` and a training cell's
`cell_ici_bytes` exceed the reference's by the parameters it leaves out.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.moe import GROUP_SIZE, _capacity


def _attn_flops_token(cfg: ArchConfig, s_ctx: float) -> float:
    """Per-token attention flops against s_ctx keys (forward)."""
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    if cfg.mla is not None:
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = 2 * d * m.q_lora_rank + 2 * m.q_lora_rank * H * qk_head
        proj += 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim)
        proj += 2 * m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
        proj += 2 * H * m.v_head_dim * d
        quad = 2 * s_ctx * H * qk_head + 2 * s_ctx * H * m.v_head_dim
        return proj + quad
    proj = 2 * d * (H + 2 * KV) * Dh + 2 * H * Dh * d
    quad = 2 * s_ctx * H * Dh * 2          # QK^T and A·V
    return proj + quad


def _ffn_flops_token(cfg: ArchConfig, layer: int) -> float:
    ffn = cfg.layer_kind(layer)[1]
    if ffn == "moe":
        e = cfg.moe
        d, f = cfg.d_model, e.d_expert_ff
        expert = e.top_k * 6 * d * f + e.num_shared * 6 * d * f
        router = 2 * d * e.num_experts
        if e.dispatch == "einsum":
            C = _capacity(GROUP_SIZE, e)
            # dispatch (gsec,gsd->egcd) and combine: two einsums of
            # 2·E·C·d flops a token each.
            return expert + router + 2 * (2 * e.num_experts * C * d)
        return expert + router
    if ffn == "none" or cfg.d_ff == 0:
        return 0.0
    return 6 * cfg.d_model * cfg.d_ff


def _ssm_flops_token(cfg: ArchConfig) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    H = d_in // s.head_dim
    P, N, G, Q = s.head_dim, s.d_state, s.n_groups, s.chunk
    proj = 2 * d * (2 * d_in + 2 * G * N + H) + 2 * d_in * d
    conv = 2 * s.conv_kernel * (d_in + 2 * G * N)
    # SSD a token: scores C·Bᵀ (Q·N a head), L∘scores·X (Q·P), states
    # B⊗x (N·P), y_off C·h (N·P).
    ssd = H * (2 * Q * N + 2 * Q * P + 2 * N * P + 2 * N * P)
    return proj + conv + ssd


def _layer_flops_token(cfg: ArchConfig, layer: int, s_ctx: float) -> float:
    mixer = cfg.layer_kind(layer)[0]
    mix = (_ssm_flops_token(cfg) if mixer == "ssm"
           else _attn_flops_token(cfg, s_ctx))
    return mix + _ffn_flops_token(cfg, layer)


def forward_flops(cfg: ArchConfig, shape: ShapeCell) -> float:
    """Global forward flops of the cell (decode: one token a sequence)."""
    B, S = shape.global_batch, shape.seq_len
    V, d = cfg.vocab_size, cfg.d_model
    if shape.kind == "decode":
        tokens, s_ctx = B, S
    else:
        tokens, s_ctx = B * S, S / 2       # causal: the average context
    if cfg.family == "ssm":
        s_ctx = 0
    total = sum(_layer_flops_token(cfg, layer, s_ctx)
                for layer in range(cfg.num_layers))
    head = 2 * d * V
    if cfg.family == "encdec":
        # The encoder over its own frames (not in a decode step), and the
        # cross-attention inside each decoder layer.
        H, Dh = cfg.num_heads, cfg.dh
        cross_per_tok = (2 * d * H * Dh + 2 * H * Dh * d
                         + 4 * cfg.encoder_seq * H * Dh)
        total += cfg.num_layers * cross_per_tok
        flops = total * tokens + head * tokens
        if shape.kind != "decode":
            enc = cfg.encoder_layers * (
                _attn_flops_token(cfg, cfg.encoder_seq / 2)
                + 6 * d * cfg.d_ff)
            flops += enc * (B * cfg.encoder_seq)
        return flops
    flops = (total + head) * tokens
    if cfg.mtp_depth and shape.kind == "train":
        # one more layer and head over the sequence
        flops += (_layer_flops_token(cfg, 0, s_ctx) + head + 4 * d * d) \
            * tokens
    return flops


def cell_flops(cfg: ArchConfig, shape: ShapeCell) -> float:
    f = forward_flops(cfg, shape)
    if shape.kind == "train":
        return f * (3.0 + (1.0 if cfg.remat else 0.0))  # fwd, bwd, remat
    return f


def params_read(cfg: ArchConfig, shape: ShapeCell) -> int:
    """Parameters a step of the cell reads: every one in training; in
    prefill and decode all but the MTP head, which only the training loss
    reads."""
    n = cfg.param_count()
    return n if shape.kind == "train" else n - cfg.mtp_param_count()


def _param_bytes(cfg: ArchConfig, shape: ShapeCell) -> float:
    bpp = {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    return params_read(cfg, shape) * bpp


def cell_hbm_bytes(cfg: ArchConfig, shape: ShapeCell, chips: int) -> float:
    """Per-device HBM traffic a step (approximate)."""
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    pbytes = _param_bytes(cfg, shape)
    act_bpp = 2 if cfg.dtype == "bfloat16" else 4
    if shape.kind == "train":
        # Weights: forward, backward and remat reads and the gradient's
        # write; the optimizer reads and writes p, m and v (the moments
        # in the parameters' dtype).
        passes = 3 + (1 if cfg.remat else 0)
        mom_bpp = 4 if cfg.param_dtype == "float32" else 2
        opt = 6 * cfg.param_count() * mom_bpp
        act = 8 * B * S * d * act_bpp * cfg.num_layers
        return (passes * pbytes + opt + act) / chips
    if shape.kind == "prefill":
        act = 4 * B * S * d * act_bpp * cfg.num_layers
        return (pbytes + act) / chips
    # decode: all weights once, the whole KV cache (or SSM state) read,
    # small activations.
    kv = 0.0
    for layer in range(cfg.num_layers):
        mixer = cfg.layer_kind(layer)[0]
        if mixer == "ssm":
            s = cfg.ssm
            H = s.expand * d // s.head_dim
            kv += B * H * s.head_dim * s.d_state * 4
        elif mixer == "mla":
            m = cfg.mla
            kv += B * S * (m.kv_lora_rank + m.qk_rope_head_dim) * act_bpp
        else:
            kv_bpp = (1 + 4 / cfg.dh) if cfg.kv_quant else act_bpp
            kv += B * S * 2 * cfg.num_kv_heads * cfg.dh * kv_bpp
    act = 8 * B * d * act_bpp * cfg.num_layers
    return (pbytes + kv + act) / chips


def analytic_record(cfg: ArchConfig, shape: ShapeCell, chips: int) -> dict:
    return {"flops": cell_flops(cfg, shape),
            "hbm_bytes_per_device": cell_hbm_bytes(cfg, shape, chips),
            "param_count": cfg.param_count(),
            "active_param_count": cfg.active_param_count()}


# ---------------------------------------------------------------------------
# Analytic per-device collective bytes
# ---------------------------------------------------------------------------
def cell_ici_bytes(cfg: ArchConfig, shape: ShapeCell, data: int, model: int,
                   fsdp_weights: bool = True, pods: int = 1) -> float:
    """Per-device interconnect bytes a step under the baseline sharding
    (ring costs, g the group size):

      FSDP weight all-gather: P·(g−1)/g a pass (forward, backward, remat);
      gradient reduce-scatter (FSDP) P·(g−1)/g, or all-reduce
        (replicated) 2·P·(g−1)/g;
      tensor parallelism: ~2 activation all-reduces a layer a pass over
        the "model" group;
      MoE all-to-all: the dispatched tokens' activations, dispatch and
        combine, a MoE layer a pass;
      a cross-pod gradient all-reduce when pods > 1 (data parallel).
    """
    B, S = shape.global_batch, shape.seq_len
    pbytes = _param_bytes(cfg, shape)
    act_bpp = 2 if cfg.dtype == "bfloat16" else 4
    ring_d = (data - 1) / data if data > 1 else 0.0
    ring_m = (model - 1) / model if model > 1 else 0.0
    ring_p = (pods - 1) / pods if pods > 1 else 0.0
    passes = 3 if (shape.kind == "train" and cfg.remat) else \
        (2 if shape.kind == "train" else 1)
    if shape.kind == "decode":
        tokens_per_dp = max(B // (data * pods), 1)
    else:
        tokens_per_dp = B * S // (data * pods)
    act = tokens_per_dp * cfg.d_model * act_bpp

    total = 0.0
    if shape.kind == "train":
        if fsdp_weights:
            total += passes * pbytes * ring_d       # weight all-gathers
            total += pbytes * ring_d                # grad reduce-scatter
        else:
            total += 2 * pbytes * ring_d            # grad all-reduce
        if pods > 1:
            total += 2 * pbytes * ring_p            # cross-pod grad AR
    # Tensor-parallel activation collectives (attention and FFN outputs).
    total += cfg.num_layers * (2 * 2 * act * ring_m) * max(passes, 1)
    if cfg.family == "encdec":
        enc_act = B * cfg.encoder_seq // (data * pods) * cfg.d_model * act_bpp
        total += cfg.encoder_layers * 2 * 2 * enc_act * ring_m * passes
    if cfg.moe is not None:
        # The all-to-all (either dispatch: tokens must reach their experts).
        moe_layers = sum(cfg.layer_kind(layer)[1] == "moe"
                         for layer in range(cfg.num_layers))
        a2a = tokens_per_dp * cfg.d_model * act_bpp * 2 * ring_m
        total += moe_layers * a2a * max(passes, 1)
    return total
