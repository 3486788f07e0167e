"""The port's multi-head latent attention (MLA) and the deepseek-v3 model
against the JAX package's, on the CPU: `mla_attend` and the absorbed
`mla_decode` over the latent cache against `repro.models.attention`, and
the reduced deepseek-v3-671b (2 layers, d_model 64, 4 heads, MLA ranks
32 / 16 with heads of 16 + 8 and values of 16, 4 experts top-2 and one
shared expert, vocab 256, float32, no MTP head: its head is
`test_torch_mtp.py`'s) against
`repro.models.transformer`: forward, decode steps, the cache, and
`loss_fn` with every gradient leaf. The flash-attention kernel's plain
version at MLA's full widths (Dh 192, Dv 128) is held against the JAX
oracle and the Pallas kernel in interpret mode. Parameters are the same
numpy draws in both packages, carried over by `repro_torch.convert`.

On the CPU the port's rmsnorm and flash attention take their kernels'
plain versions. Tolerances: 1e-5 (rtol and atol) on float32 activations,
logits, losses and gradients, as `test_torch_serve.py`; decode against
the forward at the same 1e-5 (float32, nothing dropped at the reduced
capacity factor).

Footprint: the JAX reference is called only through `repro.models`,
`repro.kernels` and `repro.configs`; full-width parameters exist only as
shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import attention as j_attn
from repro.models import transformer as j_tf
from repro_torch.configs import get_config, reduced
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import serve
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf

SIZE = dict(layers=2, d_model=64, vocab=256)
B, S = 2, 6
TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v3-671b"


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _tok(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _np(v)
    return out


def _draw_params(jcfg, seed):
    """numpy draws in the shapes of the JAX tree: weights N(0, 1/fan_in),
    tables N(0, 0.02²), norm scales (MLA's q_norm and kv_norm too)
    1 + N(0, 0.1²)."""
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(s.shape)
        if "scale" in name:
            return (1.0 + 0.1 * z).astype(np.float32)
        if "table" in name:
            return (0.02 * z).astype(np.float32)
        return (z / np.sqrt(s.shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_reduced(j_get_config(ARCH), **SIZE),
                               mtp_depth=0)
    cfg = dataclasses.replace(reduced(get_config(ARCH), **SIZE), mtp_depth=0)
    arrays = _draw_params(jcfg, seed=11)
    return dict(jcfg=jcfg, cfg=cfg, arrays=arrays,
                jparams=jax.tree.map(jnp.asarray, arrays),
                params=transformer_params_from_arrays(arrays, device="cpu"))


def _layer_attn(m):
    node = jax.tree.map(lambda a: a[0], m["arrays"]["blocks"]["l0"]["attn"])
    return (jax.tree.map(jnp.asarray, node),
            jax.tree.map(lambda a: torch.tensor(np.asarray(a)), node))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, SIZE["vocab"], shape).astype(np.int32)


def _positions(b, s):
    return np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# MLA alone
# ---------------------------------------------------------------------------
def test_mla_tree_and_widths(model):
    cfg = model["cfg"]
    p = model["params"]["blocks"]["l0"]["attn"]
    assert set(p) == {"wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wkr",
                      "wuk", "wuv", "wo"}
    m = cfg.mla
    assert tuple(p["q_norm"]["scale"].shape) == (2, m.q_lora_rank)
    assert tuple(p["kv_norm"]["scale"].shape) == (2, m.kv_lora_rank)
    assert tuple(p["wkr"]["w"].shape) == (2, cfg.d_model, m.qk_rope_head_dim)
    full = get_config(ARCH).mla
    assert (full.qk_nope_head_dim + full.qk_rope_head_dim,
            full.v_head_dim) == (192, 128)


def test_mla_qkr_matches_jax(model):
    jp, p = _layer_attn(model)
    x = _x((B, 9, SIZE["d_model"]), seed=12)
    pos = _positions(B, 9)
    want = j_attn._mla_qkr(jp, jnp.asarray(x), model["jcfg"],
                           jnp.asarray(pos))
    got = attn._mla_qkr(p, torch.tensor(x), model["cfg"], torch.tensor(pos))
    for g, w, name in zip(got, want, ("q_nope", "q_rope", "c_kv", "k_rope")):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(_np(g), _np(w), **TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_mla_attend_matches_jax(model, causal):
    jp, p = _layer_attn(model)
    x = _x((B, 37, SIZE["d_model"]), seed=13)
    pos = _positions(B, 37)
    want = j_attn.mla_attend(jp, jnp.asarray(x), model["jcfg"],
                             jnp.asarray(pos), causal=causal)
    got = attn.mla_attend(p, torch.tensor(x), model["cfg"],
                          torch.tensor(pos), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mla_decode_matches_jax_and_writes_in_place(model):
    """Eight absorbed decode steps over the latent cache against the
    reference's: each step's output, and the cache written in place at
    `length` (the same tensors, the reference's values)."""
    jp, p = _layer_attn(model)
    cfg, jcfg, m = model["cfg"], model["jcfg"], model["cfg"].mla
    T, max_len = 8, 11
    xs = _x((B, T, SIZE["d_model"]), seed=14)
    jcache = {"c_kv": jnp.zeros((B, max_len, m.kv_lora_rank)),
              "k_rope": jnp.zeros((B, max_len, m.qk_rope_head_dim))}
    cache = {k: torch.zeros(tuple(v.shape)) for k, v in jcache.items()}
    buffers = dict(cache)
    for t in range(T):
        want, jcache = j_attn.mla_decode(jp, jnp.asarray(xs[:, t:t + 1]),
                                         jcfg, jcache, t)
        got, cache = attn.mla_decode(p, torch.tensor(xs[:, t:t + 1]), cfg,
                                     cache, t)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for key in jcache:
        assert cache[key] is buffers[key]
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **TOL)
    assert float(cache["c_kv"][:, T:].abs().max()) == 0.0


def test_mla_decode_matches_mla_attend(model):
    """The absorbed decode, step by step, against the expanded prefill
    path over the same positions (the last row of each)."""
    _, p = _layer_attn(model)
    cfg, m = model["cfg"], model["cfg"].mla
    T = 7
    x = torch.tensor(_x((B, T, SIZE["d_model"]), seed=15))
    full = attn.mla_attend(p, x, cfg, torch.tensor(_positions(B, T)))
    cache = {"c_kv": torch.zeros(B, T, m.kv_lora_rank),
             "k_rope": torch.zeros(B, T, m.qk_rope_head_dim)}
    steps = [attn.mla_decode(p, x[:, t:t + 1], cfg, cache, t)[0]
             for t in range(T)]
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)), _np(full),
                               **TOL)


FA_MLA_CASES = [
    # (B, Sq, Skv, H, causal, q_offset): Dh 192, Dv 128
    (1, 40, 40, 2, True, 0),
    (2, 24, 70, 2, False, 0),
    (1, 24, 70, 2, True, 46),
]


@pytest.mark.parametrize("case", FA_MLA_CASES)
def test_flash_attention_plain_at_mla_widths_matches_jax(case):
    """The kernel's plain version at Dh 192, Dv 128 against the JAX oracle
    (no offset) and the Pallas kernel in interpret mode."""
    b, sq, skv, h, causal, q_offset = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, sq, h, 192), (b, skv, h, 192), (b, skv, h, 128)))
    got = fa_ops.flash_attention(*(torch.tensor(a) for a in (q, k, v)),
                                 causal=causal, q_offset=q_offset)
    assert tuple(got.shape) == (b, sq, h, 128)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    wants = [flash_attention_pallas(
        *(a.transpose(0, 2, 1, 3) for a in (jq, jk, jv)), causal=causal,
        block_q=8, block_k=8, q_offset=q_offset,
        interpret=True).transpose(0, 2, 1, 3)]
    if q_offset == 0:
        wants.append(j_attention_ref(jq, jk, jv, causal=causal))
    for want in wants:
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# The reduced deepseek-v3
# ---------------------------------------------------------------------------
def test_conversion_and_cache_shapes(model):
    params, cfg, jcfg = model["params"], model["cfg"], model["jcfg"]
    assert _flat(params).keys() == _flat(model["arrays"]).keys()
    assert sum(t.numel() for t in jax.tree.leaves(params)) == \
        cfg.param_count()
    cache = tf.init_cache(cfg, B, 12, device="cpu")
    jcache = j_tf.init_cache(jcfg, B, 12)
    assert jax.tree.map(lambda t: tuple(t.shape), cache) == \
        jax.tree.map(lambda a: tuple(a.shape), jcache)


def test_forward_matches_jax(model):
    toks = _tokens(1, (2, 40))
    got = tf.forward(model["params"], model["cfg"], {"tokens": _tok(toks)})
    want = j_tf.forward(model["jparams"], model["jcfg"],
                        {"tokens": jnp.asarray(toks)})
    assert got.shape == (2, 40, SIZE["vocab"])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_decode_steps_match_jax_and_forward(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    toks = _tokens(2)
    step = jax.jit(j_tf.decode_step, static_argnums=1)
    jcache = j_tf.init_cache(jcfg, B, S + 2)
    cache = tf.init_cache(cfg, B, S + 2, device="cpu")
    outs = []
    for t in range(S):
        want, jcache = step(model["jparams"], jcfg, jcache,
                            jnp.asarray(toks[:, t:t + 1]), t)
        got, cache = tf.decode_step(model["params"], cfg, cache,
                                    _tok(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        outs.append(got)
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(cache["l0"][key]),
                                   _np(jcache["l0"][key]), **TOL)
    full = tf.forward(model["params"], cfg, {"tokens": _tok(toks)})
    np.testing.assert_allclose(_np(torch.cat(outs, dim=1)), _np(full), **TOL)


def test_greedy_decode_matches_jax(model):
    from repro.launch import serve as j_serve
    toks = _tokens(5)
    want = j_serve.greedy_decode(model["jparams"], model["jcfg"], toks, 3,
                                 S + 3)
    got = serve.greedy_decode(model["params"], model["cfg"], toks, 3, S + 3)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_kernel_calls_with_mla(model, monkeypatch):
    """MLA adds two RMSNorms a layer (the q and kv latents): 4L + 1 a
    forward and a decode step; flash attention once a layer of the
    forward, none in a decode step."""
    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counted(rms_ops, "rmsnorm")
    counted(fa_ops, "flash_attention")
    cfg, L = model["cfg"], model["cfg"].num_layers
    tf.forward(model["params"], cfg, {"tokens": _tok(_tokens(1))})
    assert calls == {"rmsnorm": 4 * L + 1, "flash_attention": L}
    cache = tf.init_cache(cfg, B, 4, device="cpu")
    tf.decode_step(model["params"], cfg, cache, _tok(_tokens(1)[:, :1]), 0)
    assert calls == {"rmsnorm": 2 * (4 * L + 1), "flash_attention": L}


def test_loss_and_gradients_match_jax(model):
    """MLA's loss and every gradient leaf (the latent projections and
    norms among them) against `jax.value_and_grad`."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    batch = {"tokens": _tokens(3, (2, 40)), "labels": _tokens(4, (2, 40))}
    loss, grads = value_and_grad(
        lambda p, b: tf.loss_fn(p, cfg, b), model["params"],
        {k: torch.as_tensor(v) for k, v in batch.items()})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: j_tf.loss_fn(p, jcfg, jb))(model["jparams"])
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    got, want = _flat(grads), _flat(jgrads)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    assert float(np.abs(got["blocks.l0.attn.kv_norm.scale"]).max()) > 0
