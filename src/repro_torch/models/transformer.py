"""Model assembly for the decoder LMs: the dense, MoE, VLM, SSM and
hybrid paths of `repro/models/transformer.py`, with GQA or MLA attention.

Parameters keep the reference's tree: `blocks` holds one subtree per
position of a block group, `l0` ... `l{G-1}` (G =
`cfg.block_group_size()`: 1 for a homogeneous stack, 8 for Jamba's
[Mamba x 4, attention, Mamba x 3] pattern with an MoE FFN in every other
layer; each layer's kind is `cfg.layer_kind(layer)`), and every leaf of
position j is stacked on a leading group axis over the layers g·G + j
(the reference scans over groups; the port loops over them in Python and
takes views). The decode cache is stacked the same way, per position:
k/v for attention layers (int8 k/v and their scales with
`cfg.kv_quant`), the latent c_kv and the rotary key for MLA layers, the
SSM state and conv tail for Mamba-2 layers. An MoE layer's FFN is
`models/moe.py`'s. A model with tied embeddings has no `unembed` leaf
and reads the logits off the input table. The VLM family is the dense
stack with vision-patch embeddings ahead of the text and M-RoPE
positions in every attention layer; its loss scores the text tail only.
With `cfg.mtp_depth` the tree has DeepSeek-V3's multi-token-prediction
head `mtp` ({proj, ln_h, ln_e, layer}: one unstacked layer of the last
layer's kind), which only the loss reads.
The forward takes each stacked leaf apart with one `unbind`, whose
backward is one `stack` (indexing layer by layer would scatter every
layer's gradient into a zeroed copy of the whole stack). With
`cfg.remat`, under autograd, each group runs inside
`torch.utils.checkpoint` and is recomputed in the backward, as the
reference's `jax.checkpoint` of its scan body (`transformer.py:159`).
Public entry points:

  init_params(cfg, seed, device)                  -> param tree
  compute_params(params, cfg)                     -> matrices in cfg.dtype
  forward(params, cfg, batch)                     -> f32 logits
                                                     (batch: tokens[,
                                                     vision_embeds,
                                                     mrope_positions])
  loss_fn(params, cfg, batch)                     -> scalar loss (with
                                                     the MTP term)
  init_cache(cfg, batch, max_len, device)         -> decode cache tree
  decode_step(params, cfg, cache, token, length)  -> (logits, cache)
  prefill(params, cfg, tokens)                    -> f32 logits

Entry points that make tensors run on the card unless the caller names
another device; the others run where their inputs lie.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, moe, ssm
from repro_torch.models.common import dtype_of

# Leaves that keep their dtype in `compute_params`: the norm scales (the
# kernels take them in f32; qk-norm's too) and the SSM's f32 parameters,
# which the reference uses in f32 (`repro/models/ssm.py:160-162,196-197,
# 205`).
F32_LEAVES = frozenset({"scale", "A_log", "D", "dt_bias"})
# Subtrees that keep their dtype: the MoE router, whose logits the
# reference forms from the f32 weight (`repro/models/moe.py:51-52`).
F32_NODES = frozenset({"router"})


def _layer(tree: dict, i: int) -> dict:
    """Layer i's views of a stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The n layers' views of a stacked tree, one `unbind` per leaf."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _requires_grad(tree: dict) -> bool:
    return any(_requires_grad(v) if isinstance(v, dict) else v.requires_grad
               for v in tree.values())


def run_layers(layer_fn, blocks: dict, n: int, x: torch.Tensor,
               cfg: ArchConfig, *args, gather=None) -> torch.Tensor:
    """x through the n groups of `blocks` ({"l0": ..., "l{G-1}": ...},
    each position stacked over the groups), `layer_fn(p, x, cfg, j,
    *args)` for position j of each group in turn; each group under
    `torch.utils.checkpoint` when cfg.remat is set and autograd is on.
    `gather(j, p)`, where given (the sharded train step's), maps position
    j's layer views to the weights the layer computes with (ZeRO-3: this
    rank's blocks gathered to full weights); it runs inside the
    checkpoint, so the backward pass gathers again. None: the views."""
    remat = (cfg.remat and torch.is_grad_enabled()
             and (x.requires_grad or _requires_grad(blocks)
                  or any(isinstance(a, torch.Tensor) and a.requires_grad
                         for a in args)))
    positions = [_unstack(blocks[f"l{j}"], n) for j in range(len(blocks))]

    def group(ps, x, *args):
        if gather is not None:
            ps = [gather(j, p) for j, p in enumerate(ps)]
        for j, p in enumerate(ps):
            x = layer_fn(p, x, cfg, j, *args)
        return x

    for ps in zip(*positions):
        if remat:
            x = checkpoint(group, ps, x, *args, use_reentrant=False)
        else:
            x = group(ps, x, *args)
    return x


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def _block_init(gen, cfg: ArchConfig, j: int, pdtype, dev, lead) -> dict:
    """Position j's leaves of a group, one draw per group on `lead`."""
    d = cfg.d_model
    mixer, ffn = cfg.layer_kind(j)
    block = {"ln1": common.rmsnorm_init(d, pdtype, dev, lead)}
    if mixer == "attn":
        block["attn"] = attn.gqa_init(gen, cfg, pdtype, dev, lead)
    elif mixer == "mla":
        block["attn"] = attn.mla_init(gen, cfg, pdtype, dev, lead)
    else:
        block["ssm"] = ssm.ssm_init(gen, cfg, pdtype, dev, lead)
    if ffn != "none":
        block["ln2"] = common.rmsnorm_init(d, pdtype, dev, lead)
    if ffn == "moe":
        block["moe"] = moe.moe_init(gen, cfg, pdtype, dev, lead)
    elif ffn == "dense":
        block["ffn"] = common.swiglu_init(gen, d, cfg.d_ff, pdtype, dev,
                                          lead)
    return block


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random parameters in cfg.param_dtype, drawn from a generator seeded
    with `seed` on `device` (the card by default; the `meta` device draws
    nothing and gives the shapes alone)."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    pdtype = dtype_of(cfg.param_dtype)
    d, G = cfg.d_model, cfg.block_group_size()
    lead = (cfg.num_layers // G,)
    blocks = {f"l{j}": _block_init(gen, cfg, j, pdtype, dev, lead)
              for j in range(G)}
    params = {"embed": common.embedding_init(gen, cfg.vocab_size, d, pdtype,
                                             dev),
              "blocks": blocks,
              "ln_f": common.rmsnorm_init(d, pdtype, dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = common.embedding_init(gen, cfg.vocab_size, d,
                                                  pdtype, dev)
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": common.linear_init(gen, 2 * d, d, pdtype, dev),
            "ln_h": common.rmsnorm_init(d, pdtype, dev),
            "ln_e": common.rmsnorm_init(d, pdtype, dev),
            "layer": _block_init(gen, cfg, cfg.num_layers - 1, pdtype, dev,
                                 ())}
    return params


def compute_params(params: dict, cfg: ArchConfig) -> dict:
    """The tree with every matrix (linear weights, embedding tables, the
    SSM's conv, the stacked experts) in cfg.dtype, and the `F32_LEAVES`
    and `F32_NODES` as they are. The reference casts each weight to the
    activation dtype at every use; casting once gives the same numbers
    (the casts commute with the gathers and products) and keeps the f32
    masters out of every step."""
    adtype = dtype_of(cfg.dtype)

    def cast(tree):
        return {k: v if k in F32_NODES
                else cast(v) if isinstance(v, dict)
                else (v if k in F32_LEAVES else v.to(adtype))
                for k, v in tree.items()}

    return cast(params)


# ---------------------------------------------------------------------------
# Forward (prefill without a cache)
# ---------------------------------------------------------------------------
def _apply_layer(p: dict, x, cfg: ArchConfig, layer: int, positions,
                 mrope_positions, use_kernel):
    mixer, ffn = cfg.layer_kind(layer)
    h = common.rmsnorm(p["ln1"], x, use_kernel=use_kernel)
    if mixer == "attn":
        h = attn.gqa_attend(p["attn"], h, cfg, positions,
                            mrope_positions=mrope_positions,
                            use_kernel=use_kernel)
    elif mixer == "mla":
        h = attn.mla_attend(p["attn"], h, cfg, positions,
                            use_kernel=use_kernel)
    else:
        h = ssm.ssm_apply(p["ssm"], h, cfg, use_kernel=use_kernel)
    x = x + h
    if ffn == "none":
        return x
    return x + _ffn(p, common.rmsnorm(p["ln2"], x, use_kernel=use_kernel),
                    cfg, ffn)


def _ffn(p: dict, h, cfg: ArchConfig, ffn: str):
    return (moe.moe_apply(p["moe"], h, cfg) if ffn == "moe"
            else common.swiglu(p["ffn"], h))


def _hidden_states(params: dict, cfg: ArchConfig, batch: dict,
                   use_kernel: bool | None = None, gather=None
                   ) -> torch.Tensor:
    """The forward up to and including the final norm (B, S_total, d),
    which the MTP head reads (reference `transformer.py:168-183`);
    `gather` as `loss_fn`'s."""
    adtype = dtype_of(cfg.dtype)
    x = common.embed(params["embed"], batch["tokens"], adtype)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(adtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    mrope_positions = batch.get("mrope_positions")
    x = run_layers(_apply_layer, params["blocks"],
                   cfg.num_layers // cfg.block_group_size(), x, cfg,
                   positions, mrope_positions, use_kernel,
                   gather=None if gather is None
                   else lambda j, p: gather(f"blocks.l{j}", p))
    return common.rmsnorm(params["ln_f"], x, use_kernel=use_kernel)


def forward(params: dict, cfg: ArchConfig, batch: dict,
            use_kernel: bool | None = None) -> torch.Tensor:
    """batch: {tokens (B, S)[, vision_embeds (B, Sv, d), mrope_positions
    (3, B, S_total)]} -> f32 logits (B, S_total, V), the vision positions
    first. `use_kernel=False` takes the kernels' plain versions on the
    card."""
    x = _hidden_states(params, cfg, batch, use_kernel)
    return common.lm_head(params.get("unembed", params["embed"]), x)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict,
            use_kernel: bool | None = None, gather=None) -> torch.Tensor:
    """Next-token cross-entropy of every decoder family, from the f32
    masters: they reach the products through `compute_params`' cast, and
    the gradients flow back through it. batch: {tokens, labels} (B, S),
    and for the vlm family its vision embeddings and M-RoPE positions;
    the vision positions carry no loss, the text tail is scored. With
    `cfg.mtp_depth` (not for the vlm family) the loss adds 0.3 times
    DeepSeek-V3's multi-token-prediction loss, as the reference's
    (`transformer.py:186-207`): token t + 2 predicted from [ln_h(h_t);
    ln_e(emb(t + 1))] projected to d and through the MTP layer (as layer
    0, outside the remat checkpoints) and the shared output table.

    `gather(path, subtree)`, where given (the sharded train step's,
    `launch/steps.py`), turns a subtree of this rank's blocks at dotted
    `path` into the weights in their compute dtypes (`compute_params`'
    casts): the subtrees outside `blocks` here, each block group's inside
    its checkpoint (`run_layers`)."""
    if gather is None:
        cp = compute_params(params, cfg)
    else:
        cp = {k: v if k == "blocks" else gather(k, v)
              for k, v in params.items()}
    tokens, labels = batch["tokens"], batch["labels"]
    h = _hidden_states(cp, cfg, batch, use_kernel, gather)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        h = h[:, batch["vision_embeds"].shape[1]:]
    table = cp.get("unembed", cp["embed"])
    loss = common.cross_entropy(common.lm_head(table, h)[:, :-1],
                                labels[:, 1:])
    if not cfg.mtp_depth or cfg.family == "vlm":
        return loss
    m = cp["mtp"]
    emb_next = common.embed(cp["embed"], tokens, dtype_of(cfg.dtype))
    cat = torch.cat([
        common.rmsnorm(m["ln_h"], h[:, :-1], use_kernel=use_kernel),
        common.rmsnorm(m["ln_e"], emb_next[:, 1:], use_kernel=use_kernel)],
        dim=-1)
    x2 = common.linear(m["proj"], cat)
    B, S2 = x2.shape[:2]
    pos = torch.arange(S2, device=x2.device)[None].expand(B, S2)
    x2 = _apply_layer(m["layer"], x2, cfg, 0, pos, None, use_kernel)
    mtp_loss = common.cross_entropy(common.lm_head(table, x2)[:, :-1],
                                    labels[:, 2:])
    return loss + 0.3 * mtp_loss


# ---------------------------------------------------------------------------
# Serving: cache init / decode / prefill
# ---------------------------------------------------------------------------
def _layer_cache(cfg: ArchConfig, j: int, batch: int, max_len: int,
                 adtype, dev, lead: tuple) -> dict:
    """Group position j's zeroed cache, stacked on `lead`."""
    mixer = cfg.layer_kind(j)[0]
    if mixer == "ssm":
        return ssm.ssm_init_state(cfg, batch, adtype, dev, lead)
    lead = lead + (batch, max_len)
    if mixer == "mla":
        m = cfg.mla
        return {"c_kv": torch.zeros(lead + (m.kv_lora_rank,), dtype=adtype,
                                    device=dev),
                "k_rope": torch.zeros(lead + (m.qk_rope_head_dim,),
                                      dtype=adtype, device=dev)}
    shape = lead + (cfg.num_kv_heads, cfg.dh)
    if cfg.kv_quant:
        scales = shape[:-1] + (1,)
        return {"k_q": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(scales, dtype=torch.float32, device=dev),
                "v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v_s": torch.zeros(scales, dtype=torch.float32, device=dev)}
    return {"k": torch.zeros(shape, dtype=adtype, device=dev),
            "v": torch.zeros(shape, dtype=adtype, device=dev)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed caches, one subtree per group position ("l0" ...), each
    stacked over the groups: attention layers (B, max_len, KV, Dh) k and
    v in cfg.dtype, or with `cfg.kv_quant` int8 k_q and v_q and their f32
    scales k_s and v_s (B, max_len, KV, 1); MLA layers the latent c_kv
    (B, max_len, kv_lora_rank) and the rotary key k_rope (B, max_len,
    qk_rope_head_dim) in cfg.dtype; SSM layers the f32 state h (B, H, P,
    N) and the conv tail (B, K-1, conv_dim) in cfg.dtype."""
    dev = resolve_device(device)
    adtype = dtype_of(cfg.dtype)
    G = cfg.block_group_size()
    lead = (cfg.num_layers // G,)
    return {f"l{j}": _layer_cache(cfg, j, batch, max_len, adtype, dev, lead)
            for j in range(G)}


def decode_step(params: dict, cfg: ArchConfig, cache: dict,
                token: torch.Tensor, length: int,
                ) -> tuple[torch.Tensor, dict]:
    """token: (B, 1) int; `length` = tokens already cached. Returns
    (f32 logits (B, 1, V), the cache with the token written in: its k/v,
    its latent and rotary key, or the SSM layers' new state)."""
    adtype = dtype_of(cfg.dtype)
    x = common.embed(params["embed"], token, adtype)
    G = cfg.block_group_size()
    for g in range(cfg.num_layers // G):
        for j in range(G):
            x = _decode_layer(_layer(params["blocks"][f"l{j}"], g), x, cfg,
                              j, _layer(cache[f"l{j}"], g), length)
    x = common.rmsnorm(params["ln_f"], x)
    return common.lm_head(params.get("unembed", params["embed"]), x), cache


def _decode_layer(p: dict, x, cfg: ArchConfig, layer: int, cache: dict,
                  length: int):
    """One layer of a decode step; writes the layer's cache in place."""
    mixer, ffn = cfg.layer_kind(layer)
    h = common.rmsnorm(p["ln1"], x)
    if mixer == "attn":
        h, _ = attn.gqa_decode(p["attn"], h, cfg, cache, length)
    elif mixer == "mla":
        h, _ = attn.mla_decode(p["attn"], h, cfg, cache, length)
    else:
        h, _ = ssm.ssm_decode(p["ssm"], h, cfg, cache)
    x = x + h
    if ffn == "none":
        return x
    return x + _ffn(p, common.rmsnorm(p["ln2"], x), cfg, ffn)


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            ) -> torch.Tensor:
    """Prefill logits (the cacheless scoring path, as the reference's)."""
    return forward(params, cfg, {"tokens": tokens})
