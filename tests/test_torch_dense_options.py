"""The dense options of the port against the JAX package's, on the CPU:
qk-norm (qwen3-32b), MQA (granite-20b, one kv head), qkv biases
(qwen1.5-110b), M-RoPE and the vlm family (qwen2-vl-72b), and the int8
KV cache (`kv_quant`). Each model at its reduced config (2 layers,
d_model 128, 4 heads of 32, vocab 512, float32), from the same
numpy-seeded parameters in both packages carried over by
`repro_torch.convert`.

The draws leave nothing vacuous: the qkv biases are drawn nonzero
(0.1·N(0, 1); the reference initialises them to zeros), the qk-norm
scales 1 + 0.1·N(0, 1), the M-RoPE positions differ across t, h and w
(a 2-D patch grid for the vision tokens, then the text), and the int8
cache is checked to be what the decode step reads.

Tolerances: 1e-5 (rtol and atol) on float32 activations, logits, losses
and gradients, as `test_torch_serve.py`; int8 cache values exactly;
the data pipeline bit for bit.

Footprint: the JAX reference is called only through `repro.models`,
`repro.configs` and `repro.data.pipeline`; full-width parameters exist
only as shapes (the `meta` device and `jax.eval_shape`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import ShapeCell as JShapeCell
from repro.data import pipeline as j_pipeline
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import transformer as j_tf
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (FAMILIES, ArchConfig, MLAConfig,
                                      MoEConfig, ShapeCell, SSMConfig)
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import transformer as tf

SIZE = dict(layers=2, d_model=128, vocab=512)
B, S = 2, 6
TOL = dict(rtol=1e-5, atol=1e-5)
DECODERS = ("qwen3-32b", "granite-20b", "qwen1.5-110b")
ARCHS = DECODERS + ("qwen2-vl-72b",)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


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
    tables N(0, 0.02²), norm scales (qk-norm's too) 1 + N(0, 0.1²), qkv
    biases N(0, 0.1²)."""
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
        if name.endswith("['b']"):
            return (0.1 * z).astype(np.float32)
        return (z / np.sqrt(s.shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _model(arch, **change):
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch), **SIZE),
                               **change)
    cfg = dataclasses.replace(reduced(get_config(arch), **SIZE), **change)
    arrays = _draw_params(jcfg, seed=len(arch))
    return dict(jcfg=jcfg, cfg=cfg, arrays=arrays,
                jparams=jax.tree.map(jnp.asarray, arrays),
                params=transformer_params_from_arrays(arrays, device="cpu"))


@pytest.fixture(scope="module")
def models():
    return {arch: _model(arch) for arch in ARCHS}


def _tokens(seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, SIZE["vocab"], shape).astype(np.int32)


def _tok(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


# ---------------------------------------------------------------------------
# Configs, shapes, refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_field_for_field(models, arch):
    m = models[arch]
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (m["cfg"], m["jcfg"])):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
            [j_tf.layer_kind(jcfg, i) for i in range(jcfg.num_layers)]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_count_from_shapes(arch):
    """The full-width tree on the `meta` device against `jax.eval_shape`,
    and the exact count: the reference's `param_count()` plus the leaves
    it leaves out (norm scales, qkv biases, qk-norm scales)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    params = tf.init_params(cfg, device="meta")
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == \
        jax.tree.map(lambda s: tuple(s.shape), shapes)
    n = sum(t.numel() for t in jax.tree.leaves(params))
    L, d, H, KV, dh = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                       cfg.num_kv_heads, cfg.dh)
    extra = (2 * L + 1) * d
    extra += L * (H + 2 * KV) * dh if cfg.qkv_bias else 0
    extra += L * 2 * dh if cfg.qk_norm else 0
    assert n == cfg.param_count() == jcfg.param_count() + extra


def test_unported_families_and_mla_are_refused_by_name():
    """ROADMAP item 12d lifted the refusals of the moe family and of an
    MLA config, and 12e that of the hybrid family: all three now
    construct, and so do qwen3-moe-30b-a3b and jamba-v0.1-52b. An MoE
    `layer_period` other than 1 outside the hybrid family is still
    refused by name (the reference's homogeneous stack cannot hold mixed
    layers)."""
    base = dict(name="x", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=256)
    assert ArchConfig(family="moe", moe=MoEConfig(4, 2, 64), **base).moe \
        == MoEConfig(num_experts=4, top_k=2, d_expert_ff=64)
    hybrid = dict(base, num_layers=8, attn_layer_period=8)
    cfg = ArchConfig(family="hybrid", ssm=SSMConfig(),
                     moe=MoEConfig(4, 2, 64, layer_period=2), **hybrid)
    assert cfg.block_group_size() == 8
    for family in ("moe", "dense"):
        with pytest.raises(NotImplementedError,
                           match=f"layer_period.*{family!r}"):
            ArchConfig(family=family,
                       moe=MoEConfig(4, 2, 64, layer_period=2), **base)
    assert ArchConfig(family="dense", mla=MLAConfig(), **base).mla == \
        MLAConfig()
    assert get_config("qwen3-moe-30b-a3b").family == "moe"
    assert get_config("jamba-v0.1-52b").family == "hybrid"
    assert FAMILIES == ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


# ---------------------------------------------------------------------------
# Decoders: qk-norm, MQA, qkv bias
# ---------------------------------------------------------------------------
def test_nothing_vacuous_in_the_draws(models):
    qwen3 = models["qwen3-32b"]["params"]["blocks"]["l0"]["attn"]
    assert set(qwen3) >= {"q_norm", "k_norm"}
    assert float((qwen3["q_norm"]["scale"] - 1).abs().max()) > 0.05
    assert models["granite-20b"]["cfg"].num_kv_heads == 1
    bias = models["qwen1.5-110b"]["params"]["blocks"]["l0"]["attn"]
    for w in ("wq", "wk", "wv"):
        assert float(bias[w]["b"].abs().max()) > 0.05
    assert "b" not in bias["wo"]


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_matches_jax(models, arch):
    m = models[arch]
    toks = _tokens(1)
    got = tf.forward(m["params"], m["cfg"], {"tokens": _tok(toks)})
    want = j_tf.forward(m["jparams"], m["jcfg"],
                        {"tokens": jnp.asarray(toks)})
    assert got.shape == (B, S, SIZE["vocab"])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_qkv_biases_reach_the_logits(models):
    m = models["qwen1.5-110b"]
    toks = {"tokens": _tok(_tokens(1))}
    zeroed = jax.tree.map(torch.clone, m["params"])
    for w in ("wq", "wk", "wv"):
        zeroed["blocks"]["l0"]["attn"][w]["b"].zero_()
    a = tf.forward(m["params"], m["cfg"], toks)
    b = tf.forward(zeroed, m["cfg"], toks)
    assert float((a - b).abs().max()) > 1e-3


def _decode_both(m, toks, max_len):
    """The prompt through decode steps in both packages: each step's
    logits and final caches."""
    cfg, jcfg = m["cfg"], m["jcfg"]
    step = jax.jit(j_tf.decode_step, static_argnums=1)
    jcache = j_tf.init_cache(jcfg, B, max_len)
    cache = tf.init_cache(cfg, B, max_len, device="cpu")
    out = []
    for t in range(toks.shape[1]):
        want, jcache = step(m["jparams"], jcfg, jcache,
                            jnp.asarray(toks[:, t:t + 1]), t)
        got, cache = tf.decode_step(m["params"], cfg, cache,
                                    _tok(toks[:, t:t + 1]), t)
        out.append((got, want))
    return out, cache, jcache


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps_match_jax(models, arch):
    m = models[arch]
    toks = _tokens(2)
    steps, cache, jcache = _decode_both(m, toks, S + 2)
    for got, want in steps:
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache["l0"][key]),
                                   _np(jcache["l0"][key]), **TOL)
    full = tf.forward(m["params"], m["cfg"], {"tokens": _tok(toks)})
    np.testing.assert_allclose(_np(steps[-1][0][:, 0]), _np(full[:, -1]),
                               **TOL)


def test_kernel_calls_with_qk_norm(models, monkeypatch):
    """qk-norm adds two RMSNorms a layer (q and k over rows of Dh): 4L + 1
    a forward and a decode step; flash attention once a layer of the
    forward."""
    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counted(rms_ops, "rmsnorm")
    counted(fa_ops, "flash_attention")
    m = models["qwen3-32b"]
    L = m["cfg"].num_layers
    tf.forward(m["params"], m["cfg"], {"tokens": _tok(_tokens(1))})
    assert calls == {"rmsnorm": 4 * L + 1, "flash_attention": L}
    cache = tf.init_cache(m["cfg"], B, 4, device="cpu")
    tf.decode_step(m["params"], m["cfg"], cache, _tok(_tokens(1)[:, :1]), 0)
    assert calls == {"rmsnorm": 2 * (4 * L + 1), "flash_attention": L}


# ---------------------------------------------------------------------------
# M-RoPE and the vlm family
# ---------------------------------------------------------------------------
def _mrope_positions(b, sv, st, grid_w):
    """(3, b, sv + st) int32: the vision tokens on a 2-D patch grid (t 0,
    h the row, w the column), then the text from the grid's extent on,
    all three components alike."""
    rows = np.arange(sv) // grid_w
    cols = np.arange(sv) % grid_w
    text = max(rows.max(), cols.max()) + 1 + np.arange(st)
    pos = np.stack([np.r_[np.zeros(sv, int), text], np.r_[rows, text],
                    np.r_[cols, text]]).astype(np.int32)
    return np.broadcast_to(pos[:, None], (3, b, sv + st)).copy()


def test_apply_mrope_matches_jax_on_distinct_components():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 12, 4, 32)).astype(np.float32)
    pos = _mrope_positions(B, 8, 4, grid_w=4)
    assert not np.array_equal(pos[1], pos[2])
    sections = (4, 6, 6)
    got = common.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos),
                             sections)
    want = j_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # Against plain RoPE on the t component: the h and w sections turn.
    rope = common.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[0]))
    assert float((got - rope).abs().max()) > 1e-2
    # One position for all three components is RoPE.
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    np.testing.assert_allclose(
        _np(common.apply_mrope(torch.as_tensor(x), torch.as_tensor(same),
                               sections)), _np(rope), **TOL)


@pytest.fixture(scope="module")
def vlm_batch(models):
    cfg = models["qwen2-vl-72b"]["cfg"]
    sv, st = 4, 8
    rng = np.random.default_rng(6)
    toks = rng.integers(0, SIZE["vocab"], (B, st)).astype(np.int32)
    return {"tokens": toks, "labels": toks.copy(),
            "vision_embeds": rng.standard_normal(
                (B, sv, cfg.d_model)).astype(np.float32),
            "mrope_positions": _mrope_positions(B, sv, st, grid_w=2)}


def test_vlm_forward_matches_jax(models, vlm_batch):
    m = models["qwen2-vl-72b"]
    batch = {k: torch.as_tensor(v) for k, v in vlm_batch.items()
             if k != "labels"}
    got = tf.forward(m["params"], m["cfg"], batch)
    want = j_tf.forward(m["jparams"], m["jcfg"],
                        {k: jnp.asarray(v) for k, v in vlm_batch.items()
                         if k != "labels"})
    assert got.shape == (B, 12, SIZE["vocab"])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # The M-RoPE positions reach the attention: text-only positions give
    # other logits.
    flat = dict(batch, mrope_positions=torch.arange(12).expand(3, B, 12))
    assert float((tf.forward(m["params"], m["cfg"], flat) - got)
                 .abs().max()) > 1e-4


def test_vlm_loss_and_gradients_match_jax(models, vlm_batch):
    """The text tail's loss (the vision positions carry none) and every
    gradient leaf, vision-embedding positions and biases included."""
    m = models["qwen2-vl-72b"]
    cfg, jcfg = m["cfg"], m["jcfg"]
    loss, grads = value_and_grad(
        lambda p, b: tf.loss_fn(p, cfg, b), m["params"],
        {k: torch.as_tensor(v) for k, v in vlm_batch.items()})
    jb = {k: jnp.asarray(v) for k, v in vlm_batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: j_tf.loss_fn(p, jcfg, jb))(m["jparams"])
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    got, want = _flat(grads), _flat(jgrads)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    assert float(np.abs(got["blocks.l0.attn.wq.b"]).max()) > 0


def test_synthetic_batch_vlm_matches_jax(models):
    cfg, jcfg = models["qwen2-vl-72b"]["cfg"], models["qwen2-vl-72b"]["jcfg"]
    got = synthetic_batch(cfg, ShapeCell("t", 16, 2, "train"), 3)
    want = j_pipeline.synthetic_batch(jcfg, JShapeCell("t", 16, 2, "train"),
                                      3)
    assert got.keys() == want.keys()
    assert got["tokens"].shape == (2, 12)
    assert got["vision_embeds"].shape == (2, 4, 128)
    assert got["mrope_positions"].shape == (3, 2, 16)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# The int8 KV cache
# ---------------------------------------------------------------------------
def test_quantize_and_dequantize_kv_match_jax():
    rng = np.random.default_rng(7)
    x = (2.0 * rng.standard_normal((B, 5, 2, 32))).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: scale 0
    q, s = attn.quantize_kv(torch.as_tensor(x))
    jq, js = j_attn.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.shape == (B, 5, 2, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    got = attn.dequantize_kv(q, s, torch.float32)
    want = j_attn.dequantize_kv(jq, js, jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-7, atol=0)
    assert float(np.abs(_np(got) - x).max()) <= float(s.max()) / 2 + 1e-6


@pytest.mark.parametrize("arch", ["granite-20b", "qwen3-32b"])
def test_kv_quant_decode_steps_match_jax(arch):
    m = _model(arch, kv_quant=True)
    toks = _tokens(3)
    steps, cache, jcache = _decode_both(m, toks, S + 2)
    for got, want in steps:
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert set(cache["l0"]) == {"k_q", "k_s", "v_q", "v_s"}
    for key in ("k_q", "v_q"):
        assert cache["l0"][key].dtype == torch.int8
        np.testing.assert_array_equal(cache["l0"][key].numpy(),
                                      np.asarray(jcache["l0"][key]))
    for key in ("k_s", "v_s"):
        np.testing.assert_allclose(_np(cache["l0"][key]),
                                   _np(jcache["l0"][key]), **TOL)
    assert int(cache["l0"]["k_q"][:, :, :S].abs().max()) == 127
    # The flag reaches the step: the float cache gives other logits.
    plain, _, _ = _decode_both(_model(arch), toks, S + 2)
    assert float((steps[-1][0] - plain[-1][0]).abs().max()) > 1e-6


def test_kv_quant_cache_shapes_match_jax():
    cfg = dataclasses.replace(get_config("granite-20b"), kv_quant=True)
    jcfg = dataclasses.replace(j_get_config("granite-20b"), kv_quant=True)
    cache = tf.init_cache(cfg, 8, 96, device="meta")
    jcache = jax.eval_shape(lambda: j_tf.init_cache(jcfg, 8, 96))
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        cache) == \
        jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jcache)
