"""The port's dense decoder and serving path against the JAX package's, on
the CPU, at a reduced stablelm-3b (2 layers, d_model 128, 4 heads of 32
over 2 kv heads, vocab 512, float32), from the same numpy-seeded
parameters carried over by `repro_torch.convert`.

On the CPU the port's rmsnorm and flash attention take their kernels'
plain versions; the JAX model takes its jnp paths. Tolerances: 1e-5
(rtol and atol) on float32 activations and logits (|logits| < 1, sums in
another order); greedy tokens exactly. The bfloat16 model is held at
0.05 (rtol and atol on the logits): the two frameworks round to bfloat16
at other places inside a layer.

Footprint: the JAX reference is called only through `repro.models`,
`repro.kernels` and `repro.launch.serve`; nothing here sets threads,
default dtypes, environment variables, JAX config or a global seed, and
full-width parameters exist only as shapes (the `meta` device and
`jax.eval_shape`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch import serve as j_serve
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import transformer as j_tf
from repro_torch.configs import get_config, reduced
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import transformer as tf

SIZE = dict(layers=2, d_model=128, vocab=512)
B, S, MAX_NEW = 2, 6, 3
TOL = dict(rtol=1e-5, atol=1e-5)
STABLELM_3B_PARAMS = 2_795_276_800


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _tok(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _draw_params(jcfg, seed):
    """numpy draws in the shapes of the JAX tree: weights N(0, 1/fan_in),
    tables N(0, 0.02²), norm scales 1 + N(0, 0.1²) (so the scale matters)."""
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
    jcfg = j_reduced(j_get_config("stablelm-3b"), **SIZE)
    cfg = reduced(get_config("stablelm-3b"), **SIZE)
    arrays = _draw_params(jcfg, seed=0)
    rng = np.random.default_rng(1)
    return dict(jcfg=jcfg, cfg=cfg,
                jparams=jax.tree.map(jnp.asarray, arrays),
                params=transformer_params_from_arrays(arrays, device="cpu"),
                tokens=rng.integers(0, SIZE["vocab"], (B, S)).astype(
                    np.int32))


@pytest.fixture(scope="module")
def jax_greedy(model):
    return j_serve.greedy_decode(model["jparams"], model["jcfg"],
                                 model["tokens"], MAX_NEW, S + MAX_NEW)


# ---------------------------------------------------------------------------
# Configs and shapes
# ---------------------------------------------------------------------------
def test_reduced_config_matches_jax(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.dh) == (4, 2, 32)
    assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
        [j_tf.layer_kind(jcfg, i) for i in range(jcfg.num_layers)]


def test_full_width_parameter_count_from_shapes():
    """stablelm-3b at full width, from shapes alone: the port's tree on the
    `meta` device against the JAX tree from `jax.eval_shape`."""
    cfg, jcfg = get_config("stablelm-3b"), j_get_config("stablelm-3b")
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    params = tf.init_params(cfg, device="meta")
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    got = jax.tree.map(lambda t: tuple(t.shape), params)
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert got == want
    n = sum(t.numel() for t in jax.tree.leaves(params))
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    assert n == cfg.param_count() == STABLELM_3B_PARAMS
    assert n == jcfg.param_count() + norms        # the JAX count skips norms
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(params))


def test_convert_refuses_parameters_of_unported_paths():
    """The conversion refuses a leaf no model has. ROADMAP item 12d ported
    the MoE router and MLA's down-projection, and 12g the MTP head
    (deepseek): those leaves convert, the head's layer without a group
    axis."""
    w = np.zeros((1, 8, 8), np.float32)
    tree = {"blocks": {"l0": {"moe": {"router": {"w": w}}}}}
    got = transformer_params_from_arrays(tree, device="cpu")
    assert tuple(got["blocks"]["l0"]["moe"]["router"]["w"].shape) == \
        (1, 8, 8)
    tree = {"blocks": {"l0": {"attn": {"wdq": {"w": w},
                                       "q_norm": {"scale": w[:, 0]}}}}}
    got = transformer_params_from_arrays(tree, device="cpu")
    assert tuple(got["blocks"]["l0"]["attn"]["wdq"]["w"].shape) == (1, 8, 8)
    assert tuple(got["blocks"]["l0"]["attn"]["q_norm"]["scale"].shape) == \
        (1, 8)
    tree = {"mtp": {"proj": {"w": w[0]}, "ln_h": {"scale": w[0, 0]},
                    "layer": {"ln1": {"scale": w[0, 0]},
                              "moe": {"router": {"w": w[0]}}}}}
    got = transformer_params_from_arrays(tree, device="cpu")["mtp"]
    assert tuple(got["layer"]["moe"]["router"]["w"].shape) == (8, 8)
    with pytest.raises(NotImplementedError, match="'blocks'.*'mtp'"):
        transformer_params_from_arrays({"mtp": {"blocks": {}}},
                                       device="cpu")
    tree = {"blocks": {"l0": {"attn": {"wo": {"w": w, "b": w[:, 0]}}}}}
    with pytest.raises(NotImplementedError, match="'b'"):
        transformer_params_from_arrays(tree, device="cpu")


def test_compute_params_casts_matrices_only(model):
    cfg = dataclasses.replace(model["cfg"], dtype="bfloat16")
    cp = tf.compute_params(model["params"], cfg)
    for path, t in jax.tree_util.tree_leaves_with_path(cp):
        want = torch.float32 if "scale" in jax.tree_util.keystr(path) \
            else torch.bfloat16
        assert t.dtype == want


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def test_common_layers_match_jax(model):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, 128)).astype(np.float32)
    heads = rng.normal(size=(B, S, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S) + 3, (B, S)).astype(np.int32)
    jlp = _layer0(model["jparams"]["blocks"]["l0"])
    tlp = tf._layer(model["params"]["blocks"]["l0"], 0)
    pairs = [
        (common.rmsnorm(tlp["ln1"], torch.as_tensor(x)),
         j_common.rmsnorm(jlp["ln1"], jnp.asarray(x))),
        (common.apply_rope(torch.as_tensor(heads), torch.as_tensor(pos)),
         j_common.apply_rope(jnp.asarray(heads), jnp.asarray(pos))),
        (common.swiglu(tlp["ffn"], torch.as_tensor(x)),
         j_common.swiglu(jlp["ffn"], jnp.asarray(x))),
        (common.embed(model["params"]["embed"], _tok(model["tokens"]),
                      torch.float32),
         j_common.embed(model["jparams"]["embed"],
                        jnp.asarray(model["tokens"]), jnp.float32)),
        (common.lm_head(model["params"]["unembed"], torch.as_tensor(x)),
         j_common.lm_head(model["jparams"]["unembed"], jnp.asarray(x))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _attn_inputs(model):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    return (x, pos, _layer0(model["jparams"]["blocks"]["l0"])["attn"],
            tf._layer(model["params"]["blocks"]["l0"], 0)["attn"])


def test_gqa_attend_and_prefill_cache_match_jax(model):
    x, pos, jp, tp = _attn_inputs(model)
    cfg, jcfg = model["cfg"], model["jcfg"]
    got = attn.gqa_attend(tp, torch.as_tensor(x), cfg, torch.as_tensor(pos))
    want = j_attn.gqa_attend(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    got, gcache = attn.gqa_prefill_cache(tp, torch.as_tensor(x), cfg,
                                         torch.as_tensor(pos))
    want, wcache = j_attn.gqa_prefill_cache(jp, jnp.asarray(x), jcfg,
                                            jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(gcache[key]), _np(wcache[key]), **TOL)


def test_gqa_decode_and_decode_attention_match_jax(model):
    """One decode step of the attention layer against a half-filled cache,
    and decode_attention alone over a cache prefix."""
    x, _, jp, tp = _attn_inputs(model)
    cfg, jcfg = model["cfg"], model["jcfg"]
    rng = np.random.default_rng(4)
    kc = rng.normal(size=(B, 8, 2, 32)).astype(np.float32)
    vc = rng.normal(size=(B, 8, 2, 32)).astype(np.float32)
    length = 4
    jy, jcache = j_attn.gqa_decode(
        jp, jnp.asarray(x[:, :1]), jcfg,
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, length)
    cache = {"k": torch.as_tensor(kc.copy()), "v": torch.as_tensor(vc.copy())}
    y, cache = attn.gqa_decode(tp, torch.as_tensor(x[:, :1]), cfg, cache,
                               length)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **TOL)
    q = rng.normal(size=(B, 1, 4, 32)).astype(np.float32)
    got = attn.decode_attention(torch.as_tensor(q), torch.as_tensor(kc),
                                torch.as_tensor(vc), 5)
    want = j_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), 5)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# The model and the serving path
# ---------------------------------------------------------------------------
def test_forward_matches_jax(model):
    got = tf.forward(model["params"], model["cfg"],
                     {"tokens": _tok(model["tokens"])})
    want = j_tf.forward(model["jparams"], model["jcfg"],
                        {"tokens": jnp.asarray(model["tokens"])})
    assert got.dtype == torch.float32 and got.shape == (B, S, 512)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(
        _np(tf.prefill(model["params"], model["cfg"], _tok(model["tokens"]))),
        _np(got), rtol=0, atol=0)


def test_decode_steps_match_jax(model):
    """The prompt replayed through decode steps, as serving warms its
    cache: logits at every step against the JAX decode step, and the
    last step against the cacheless forward."""
    cfg, jcfg, toks = model["cfg"], model["jcfg"], model["tokens"]
    step = jax.jit(j_tf.decode_step, static_argnums=1)
    jcache = j_tf.init_cache(jcfg, B, S + 1)
    cache = tf.init_cache(cfg, B, S + 1, device="cpu")
    for t in range(S):
        want, jcache = step(model["jparams"], jcfg, jcache,
                            jnp.asarray(toks[:, t:t + 1]), t)
        got, cache = tf.decode_step(model["params"], cfg, cache,
                                    _tok(toks[:, t:t + 1]), t)
        assert got.shape == (B, 1, 512)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    full = tf.forward(model["params"], cfg, {"tokens": _tok(toks)})
    np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, -1]), **TOL)


def test_greedy_decode_matches_jax(model, jax_greedy):
    got = serve.greedy_decode(model["params"], model["cfg"], model["tokens"],
                              MAX_NEW, S + MAX_NEW)
    assert got.dtype == np.int32 and got.shape == (B, MAX_NEW)
    np.testing.assert_array_equal(got, jax_greedy)


@pytest.mark.parametrize("max_batch", [1, 2])
def test_serve_requests_matches_jax_tokens(model, jax_greedy, max_batch):
    """Batched serving at the power knob's two settings gives each request
    the tokens of the JAX package's greedy decode."""
    reqs = [serve.Request(rid=i, prompt=model["tokens"][i], max_new=MAX_NEW)
            for i in range(B)]
    stats = serve.serve_requests(model["params"], model["cfg"], reqs,
                                 max_batch=max_batch, max_len=S + MAX_NEW)
    for r in reqs:
        assert r.tokens == jax_greedy[r.rid].tolist()
        assert r.done_s is not None
    assert stats.batch_size_used == max_batch
    assert stats.latencies_s.shape == (B,) and stats.throughput_tok_s > 0
    assert stats.p(50) <= stats.p(95)


def test_kernel_calls_on_the_serving_path(model, monkeypatch):
    """What chip_smoke.py expects of the card: per batch, one forward and
    S + max_new - 1 decode steps, each with 2·L + 1 RMSNorms; flash
    attention once per layer of the forward."""
    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counted(rms_ops, "rmsnorm")
    counted(fa_ops, "flash_attention")
    cfg = model["cfg"]
    serve.greedy_decode(model["params"], cfg, model["tokens"], MAX_NEW,
                        S + MAX_NEW)
    L = cfg.num_layers
    assert calls == {"rmsnorm": (2 * L + 1) * (1 + S + MAX_NEW - 1),
                     "flash_attention": L}


def test_bfloat16_forward_close_to_jax(model):
    """The card's activation dtype, on the CPU in both frameworks."""
    cfg = dataclasses.replace(model["cfg"], dtype="bfloat16")
    jcfg = dataclasses.replace(model["jcfg"], dtype="bfloat16")
    got = tf.forward(model["params"], cfg, {"tokens": _tok(model["tokens"])})
    want = j_tf.forward(model["jparams"], jcfg,
                        {"tokens": jnp.asarray(model["tokens"])})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=0.05, atol=0.05)
