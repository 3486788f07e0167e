"""Whisper-style encoder-decoder backbone (audio frontend stubbed): the
port of `repro/models/encdec.py`.

The conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, 1500, d). Encoder = non-causal
self-attention stack; decoder = causal self-attention + cross-attention
over the encoder output. Positions are sinusoidal for both, no RoPE.

Parameters keep the reference's tree, so that conversion is one walk:
`enc_blocks` and `dec_blocks` hold each per-layer leaf stacked on a
leading layer axis, beside `enc_ln`, `embed` (tied: it is the LM head)
and `dec_ln`. Full-sequence attention (the encoder, the decoder's self-
and cross-attention in `decode`) goes through the hand-written
flash-attention kernel on the card and every norm through the rmsnorm
kernel; `decode_step` attends with plain torch `decode_attention`, as the
reference. With `cfg.remat`, under autograd, each layer runs inside
`torch.utils.checkpoint`, as the reference's `jax.checkpoint`.

The serving cache is (L, B, max_len, KV, Dh) self-attention k/v and
(L, B, S_enc, KV, Dh) cross-attention k/v. `start_cache` computes each
decoder layer's cross k/v once; `decode_step` writes the new token's
self-attention k/v into the cache it was given.

  init_params(cfg, seed, device)                   -> param tree
  encode(params, cfg, frames)                      -> (B, S_enc, d)
  decode(params, cfg, tokens, enc_out)             -> f32 logits
  forward(params, cfg, batch)                      -> f32 logits
  loss_fn(params, cfg, batch)                      -> scalar loss
  init_cache(cfg, batch, max_len, device)          -> zeroed cache
  start_cache(params, cfg, enc_out, batch, max_len) -> cache
  decode_step(params, cfg, cache, token, length)   -> (logits, cache)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.common import dtype_of, linear, linear_init
from repro_torch.models.transformer import (_layer, compute_params,
                                            run_layers)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def _xattn_init(gen, cfg: ArchConfig, dtype, device, lead: tuple) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    return {"wq": linear_init(gen, d, H * Dh, dtype, device, lead),
            "wk": linear_init(gen, d, KV * Dh, dtype, device, lead),
            "wv": linear_init(gen, d, KV * Dh, dtype, device, lead),
            "wo": linear_init(gen, H * Dh, d, dtype, device, lead)}


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random parameters in cfg.param_dtype, drawn from a generator seeded
    with `seed` on `device` (the card by default; the `meta` device draws
    nothing and gives the shapes alone)."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    pdtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    enc = (cfg.encoder_layers,)
    dec = (cfg.num_layers,)
    return {
        "enc_blocks": {
            "ln1": common.rmsnorm_init(d, pdtype, dev, enc),
            "attn": attn.gqa_init(gen, cfg, pdtype, dev, enc),
            "ln2": common.rmsnorm_init(d, pdtype, dev, enc),
            "ffn": common.swiglu_init(gen, d, cfg.d_ff, pdtype, dev, enc)},
        "enc_ln": common.rmsnorm_init(d, pdtype, dev),
        "embed": common.embedding_init(gen, cfg.vocab_size, d, pdtype, dev),
        "dec_blocks": {
            "ln1": common.rmsnorm_init(d, pdtype, dev, dec),
            "attn": attn.gqa_init(gen, cfg, pdtype, dev, dec),
            "lnx": common.rmsnorm_init(d, pdtype, dev, dec),
            "xattn": _xattn_init(gen, cfg, pdtype, dev, dec),
            "ln2": common.rmsnorm_init(d, pdtype, dev, dec),
            "ffn": common.swiglu_init(gen, d, cfg.d_ff, pdtype, dev, dec)},
        "dec_ln": common.rmsnorm_init(d, pdtype, dev),
    }


# ---------------------------------------------------------------------------
# Encoder and teacher-forced decoder
# ---------------------------------------------------------------------------
def _with_positions(x: torch.Tensor, d: int) -> torch.Tensor:
    table = common.sinusoidal_positions(x.shape[1], d, x.device)
    return x + table.to(x.dtype)[None]


def _enc_layer(p: dict, x, cfg: ArchConfig, layer: int, positions,
               use_kernel):
    h = common.rmsnorm(p["ln1"], x, use_kernel=use_kernel)
    x = x + attn.gqa_attend(p["attn"], h, cfg, positions, causal=False,
                            use_rope=False, use_kernel=use_kernel)
    h = common.rmsnorm(p["ln2"], x, use_kernel=use_kernel)
    return x + common.swiglu(p["ffn"], h)


def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor,
           use_kernel: bool | None = None, gather=None) -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed frame embeddings (conv stub) ->
    the normed encoder output (B, S_enc, d) in cfg.dtype. `gather` as
    `loss_fn`'s."""
    x = _with_positions(frames.to(dtype_of(cfg.dtype)), cfg.d_model)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x = run_layers(_enc_layer, {"l0": params["enc_blocks"]},
                   cfg.encoder_layers, x, cfg, positions, use_kernel,
                   gather=None if gather is None
                   else lambda j, p: gather("enc_blocks", p))
    return common.rmsnorm(params["enc_ln"], x, use_kernel=use_kernel)


def _enc_kv(p: dict, enc_out: torch.Tensor, cfg: ArchConfig):
    """One decoder layer's cross-attention k, v (B, S_enc, KV, Dh)."""
    B, S = enc_out.shape[:2]
    KV, Dh = cfg.num_kv_heads, cfg.dh
    return (linear(p["wk"], enc_out).reshape(B, S, KV, Dh),
            linear(p["wv"], enc_out).reshape(B, S, KV, Dh))


def _cross_attend(p: dict, x, enc_kv, cfg: ArchConfig, use_kernel):
    B, S = x.shape[:2]
    H, Dh = cfg.num_heads, cfg.dh
    q = linear(p["wq"], x).reshape(B, S, H, Dh)
    out = fa_ops.flash_attention(q, *enc_kv, causal=False,
                                 use_kernel=use_kernel)
    return linear(p["wo"], out.reshape(B, S, H * Dh))


def _dec_layer(p: dict, x, cfg: ArchConfig, layer: int, enc_out, positions,
               use_kernel):
    h = common.rmsnorm(p["ln1"], x, use_kernel=use_kernel)
    x = x + attn.gqa_attend(p["attn"], h, cfg, positions, causal=True,
                            use_rope=False, use_kernel=use_kernel)
    h = common.rmsnorm(p["lnx"], x, use_kernel=use_kernel)
    x = x + _cross_attend(p["xattn"], h, _enc_kv(p["xattn"], enc_out, cfg),
                          cfg, use_kernel)
    h = common.rmsnorm(p["ln2"], x, use_kernel=use_kernel)
    return x + common.swiglu(p["ffn"], h)


def decode(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
           enc_out: torch.Tensor, use_kernel: bool | None = None,
           gather=None) -> torch.Tensor:
    """Teacher-forced decoder -> f32 logits (B, S_dec, V)."""
    x = common.embed(params["embed"], tokens, dtype_of(cfg.dtype))
    x = _with_positions(x, cfg.d_model)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x = run_layers(_dec_layer, {"l0": params["dec_blocks"]},
                   cfg.num_layers, x, cfg, enc_out, positions, use_kernel,
                   gather=None if gather is None
                   else lambda j, p: gather("dec_blocks", p))
    x = common.rmsnorm(params["dec_ln"], x, use_kernel=use_kernel)
    return common.lm_head(params["embed"], x)


def forward(params: dict, cfg: ArchConfig, batch: dict,
            use_kernel: bool | None = None, gather=None) -> torch.Tensor:
    """batch: {frames (B, S_enc, d), tokens (B, S)} -> f32 logits (B, S,
    V). `use_kernel=False` takes the kernels' plain versions on the
    card. `gather` as `loss_fn`'s."""
    enc_out = encode(params, cfg, batch["frames"], use_kernel, gather)
    return decode(params, cfg, batch["tokens"], enc_out, use_kernel, gather)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict,
            use_kernel: bool | None = None, gather=None) -> torch.Tensor:
    """Next-token cross-entropy from the f32 masters, which reach the
    products through `compute_params`' cast. batch: {frames, tokens,
    labels}. `gather(path, subtree)`, where given (the sharded train
    step's), turns this rank's blocks into the weights in their compute
    dtypes: the subtrees outside the stacks here, each encoder and
    decoder layer's inside its checkpoint (`run_layers`)."""
    if gather is None:
        cp = compute_params(params, cfg)
    else:
        cp = {k: v if k in ("enc_blocks", "dec_blocks") else gather(k, v)
              for k, v in params.items()}
    logits = forward(cp, cfg, batch, use_kernel=use_kernel, gather=gather)
    return common.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed self-attention k/v (L, B, max_len, KV, Dh) and cross k/v
    (L, B, S_enc, KV, Dh), in cfg.dtype."""
    dev = resolve_device(device)
    adtype = dtype_of(cfg.dtype)
    L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.dh

    def zeros(S):
        return torch.zeros((L, batch, S, KV, Dh), dtype=adtype, device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "enc_k": zeros(cfg.encoder_seq), "enc_v": zeros(cfg.encoder_seq)}


def start_cache(params: dict, cfg: ArchConfig, enc_out: torch.Tensor,
                batch: int, max_len: int) -> dict:
    """The decode cache on enc_out's device: zeroed self-attention k/v and
    each decoder layer's cross-attention k/v from the encoder output,
    computed once here."""
    adtype = dtype_of(cfg.dtype)
    L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.dh
    S_enc = enc_out.shape[1]
    dev = enc_out.device
    shape = (L, batch, S_enc, KV, Dh)
    enc_k = torch.empty(shape, dtype=adtype, device=dev)
    enc_v = torch.empty(shape, dtype=adtype, device=dev)
    blocks = params["dec_blocks"]["xattn"]
    for i in range(L):
        enc_k[i], enc_v[i] = _enc_kv(_layer(blocks, i), enc_out, cfg)
    self_shape = (L, batch, max_len, KV, Dh)
    return {"k": torch.zeros(self_shape, dtype=adtype, device=dev),
            "v": torch.zeros(self_shape, dtype=adtype, device=dev),
            "enc_k": enc_k, "enc_v": enc_v}


def decode_step(params: dict, cfg: ArchConfig, cache: dict,
                token: torch.Tensor, length: int,
                ) -> tuple[torch.Tensor, dict]:
    """token: (B, 1) int; `length` = tokens already cached. Returns (f32
    logits (B, 1, V), the cache with the token's self-attention k/v
    written at `length` in place)."""
    adtype = dtype_of(cfg.dtype)
    B = token.shape[0]
    x = common.embed(params["embed"], token, adtype)
    max_len = cache["k"].shape[2]            # (L, B, max_len, KV, Dh)
    table = common.sinusoidal_positions(max_len, cfg.d_model, x.device)
    x = x + table.to(adtype)[length][None, None]
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    blocks = params["dec_blocks"]
    for i in range(cfg.num_layers):
        p = _layer(blocks, i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = common.rmsnorm(p["ln1"], x)
        q = linear(p["attn"]["wq"], h).reshape(B, 1, H, Dh)
        kc[:, length] = linear(p["attn"]["wk"], h).reshape(B, KV, Dh)
        vc[:, length] = linear(p["attn"]["wv"], h).reshape(B, KV, Dh)
        o = attn.decode_attention(q, kc, vc, length + 1)
        x = x + linear(p["attn"]["wo"], o.reshape(B, 1, H * Dh))
        h = common.rmsnorm(p["lnx"], x)
        q = linear(p["xattn"]["wq"], h).reshape(B, 1, H, Dh)
        ek, ev = cache["enc_k"][i], cache["enc_v"][i]
        o = attn.decode_attention(q, ek, ev, ek.shape[1])
        x = x + linear(p["xattn"]["wo"], o.reshape(B, 1, H * Dh))
        h = common.rmsnorm(p["ln2"], x)
        x = x + common.swiglu(p["ffn"], h)
    x = common.rmsnorm(params["dec_ln"], x)
    return common.lm_head(params["embed"], x), cache
