"""The port's mixture-of-experts FFN and the moe family against the JAX
package's, on the CPU: `repro_torch.models.moe` against
`repro.models.moe` (routing, groups, capacity, both dispatches with slots
dropped, a shared expert) and the reduced qwen3-moe-30b-a3b (2 layers,
d_model 64, 4 heads of 16 over 2 kv heads, 4 experts top-2, vocab 256,
float32) against `repro.models.transformer`: forward, decode steps and
`loss_fn` with every gradient leaf. Parameters are the same numpy draws
in both packages, carried over by `repro_torch.convert`.

`reduced()`'s capacity factor 8 drops no slot, so the dispatch tests run
at 0.5 as well, over 300 tokens in 2 groups of 150 (256 does not divide
300), and assert that slots were dropped and that the count is the one a
plain loop over the reference's routing gives.

Tolerances: router weights 1e-6; activations, logits, losses and
gradients 1e-5 (rtol and atol), as `test_torch_serve.py`; ids, group
sizes, capacities and drop counts exactly.

Footprint: the JAX reference is called only through `repro.models` and
`repro.configs`; full-width parameters exist only as shapes (the `meta`
device and `jax.eval_shape`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch.configs import get_config, reduced
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import moe
from repro_torch.models import transformer as tf

SIZE = dict(layers=2, d_model=64, vocab=256)
B, S = 2, 6
TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen3-moe-30b-a3b"
DROP_CF = 0.5


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
    """numpy draws in the shapes of the JAX tree: weights N(0, 1/fan_in)
    (the stacked experts' fan-in is their second-to-last axis, as the
    router's), tables N(0, 0.02²), norm scales 1 + N(0, 0.1²)."""
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


def _configs(arch=ARCH, **moe_change):
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch), **SIZE),
                               mtp_depth=0)
    cfg = dataclasses.replace(reduced(get_config(arch), **SIZE), mtp_depth=0)
    if moe_change:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_change))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_change))
    return jcfg, cfg


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs()
    arrays = _draw_params(jcfg, seed=3)
    return dict(jcfg=jcfg, cfg=cfg, arrays=arrays,
                jparams=jax.tree.map(jnp.asarray, arrays),
                params=transformer_params_from_arrays(arrays, device="cpu"))


def _layer_moe(arrays, arch=ARCH):
    """Layer 0's MoE parameters, numpy, in both packages."""
    node = jax.tree.map(lambda a: a[0], arrays["blocks"]["l0"]["moe"])
    return (jax.tree.map(jnp.asarray, node),
            jax.tree.map(lambda a: torch.tensor(np.asarray(a)), node))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _reference_drops(ids, C, E):
    """Slots at or past C in their expert's queue, from a plain loop over
    the reference's ids (G, gs, k): token-major, slot-minor."""
    dropped = 0
    for group in np.asarray(ids):
        seen = np.zeros(E, int)
        for token in group:
            for e in token:
                dropped += seen[e] >= C
                seen[e] += 1
    return int(dropped)


# ---------------------------------------------------------------------------
# Configs, shapes, counts
# ---------------------------------------------------------------------------
def _same_fields(cfg, jcfg):
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(got):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_configs_match_jax_field_for_field(arch):
    jr, r = _configs(arch)
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)), (r, jr)):
        _same_fields(cfg, jcfg)
        assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
            [j_tf.layer_kind(jcfg, i) for i in range(jcfg.num_layers)]
    assert (r.moe.num_experts, r.moe.top_k, r.moe.capacity_factor) == \
        (4, 2, 8.0)


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_full_width_parameter_count_from_shapes(arch):
    """The full-width tree on the `meta` device against `jax.eval_shape`
    (deepseek's MTP head included: the training loss reads it), and the
    exact count: the reference's `param_count()` plus the leaves it
    leaves out (norm scales: ln1, ln2, ln_f, qk-norm, MLA's q_norm and
    kv_norm; the MTP head)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    params = tf.init_params(cfg, device="meta")
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    assert ("mtp" in shapes) == ("mtp" in params) == bool(cfg.mtp_depth)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == \
        jax.tree.map(lambda s: tuple(s.shape), shapes)
    n = sum(t.numel() for t in jax.tree.leaves(params))
    L, d = cfg.num_layers, cfg.d_model
    extra = (2 * L + 1) * d + (L * 2 * cfg.dh if cfg.qk_norm else 0)
    if cfg.mla is not None:
        extra += L * (cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank)
    if cfg.mtp_depth:
        extra += sum(t.numel() for t in jax.tree.leaves(params["mtp"]))
    assert n == cfg.param_count() == jcfg.param_count() + extra
    assert round(n / 1e9, 1) == {ARCH: 30.5, "deepseek-v3-671b": 715.4}[arch]


def test_conversion_and_param_count_of_the_reduced_tree(model):
    """Every leaf of the reference's tree converts, with its shape; the
    router stays f32 through `compute_params` where the matrices go to
    bfloat16."""
    params = model["params"]
    assert _flat(params).keys() == _flat(model["arrays"]).keys()
    for key, a in _flat(model["arrays"]).items():
        np.testing.assert_array_equal(_flat(params)[key], a, err_msg=key)
    assert sum(t.numel() for t in jax.tree.leaves(params)) == \
        model["cfg"].param_count()
    cp = tf.compute_params(params,
                           dataclasses.replace(model["cfg"],
                                               dtype="bfloat16"))
    layer = cp["blocks"]["l0"]["moe"]
    assert layer["router"]["w"].dtype == torch.float32
    assert layer["w_gate"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------
def test_router_matches_jax(model):
    jp, p = _layer_moe(model["arrays"])
    x = _x((3, 50, SIZE["d_model"]), seed=4)
    jw, jids = j_moe._router(jp, jnp.asarray(x), model["jcfg"].moe)
    w, ids = moe._router(p, torch.tensor(x), model["cfg"].moe)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    assert w.dtype == torch.float32


@pytest.mark.parametrize("shape", [(3, 100), (2, 128), (1, 7), (8, 1),
                                   (4, 96)])
def test_group_matches_jax(shape):
    """The largest divisor of the token count at most 256 (300 -> 150,
    7 -> 7, 384 -> 192)."""
    x = _x(shape + (4,), seed=5)
    jg, jG, jgs = j_moe._group(jnp.asarray(x), j_moe.GROUP_SIZE)
    g, G, gs = moe._group(torch.tensor(x), moe.GROUP_SIZE)
    assert (G, gs) == (jG, jgs)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_capacity_matches_jax(arch):
    for cf in (0.5, 1.0, 1.25, 8.0):
        e = dataclasses.replace(get_config(arch).moe, capacity_factor=cf)
        je = dataclasses.replace(j_get_config(arch).moe, capacity_factor=cf)
        for tokens in (1, 4, 8, 64, 150, 255, 256):
            c = moe._capacity(tokens, e)
            assert c == j_moe._capacity(tokens, je)
            assert c >= 4 and c % 4 == 0


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("cf", [DROP_CF, 8.0])
def test_dispatch_matches_jax(model, dispatch, cf):
    """Both dispatches at the reduced factor (no drop) and at 0.5 over 2
    groups of 150 tokens, where the count of dropped slots is the plain
    loop's over the reference's routing, and nonzero."""
    jcfg, cfg = _configs(dispatch=dispatch, capacity_factor=cf)
    jp, p = _layer_moe(model["arrays"])
    x = _x((2, 150, SIZE["d_model"]), seed=6)
    want = j_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    got = moe.moe_apply(p, torch.tensor(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jxg, _, gs = j_moe._group(jnp.asarray(x), j_moe.GROUP_SIZE)
    _, jids = j_moe._router(jp, jxg, jcfg.moe)
    C = j_moe._capacity(gs, jcfg.moe)
    xg, _, _ = moe._group(torch.tensor(x), moe.GROUP_SIZE)
    _, ids = moe._router(p, xg, cfg.moe)
    dropped = int((moe._positions(ids, cfg.moe.num_experts) >= C).sum())
    assert dropped == _reference_drops(jids, C, jcfg.moe.num_experts)
    assert (dropped > 0) == (cf == DROP_CF)


def test_drops_move_the_output(model):
    """Not vacuous: at 0.5 the dropped slots change the output."""
    _, p = _layer_moe(model["arrays"])
    x = torch.tensor(_x((2, 150, SIZE["d_model"]), seed=6))
    lo = moe.moe_apply(p, x, _configs(capacity_factor=DROP_CF)[1])
    hi = moe.moe_apply(p, x, _configs()[1])
    assert float((lo - hi).abs().max()) > 1e-2


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_shared_expert_matches_jax(dispatch):
    """deepseek's MoE layer: one shared SwiGLU expert beside the routed
    ones, at a factor that drops slots."""
    arch = "deepseek-v3-671b"
    jcfg, cfg = _configs(arch, dispatch=dispatch, capacity_factor=DROP_CF)
    arrays = _draw_params(jcfg, seed=8)
    jp, p = _layer_moe(arrays, arch)
    assert set(p["shared"]) == {"w_gate", "w_up", "w_down"}
    x = _x((2, 150, SIZE["d_model"]), seed=9)
    want = j_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    got = moe.moe_apply(p, torch.tensor(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    routed = dict(p)
    del routed["shared"]
    no_shared = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_shared=0))
    alone = moe.moe_apply(routed, torch.tensor(x), no_shared)
    assert float((got - alone).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------
def _tokens(seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, SIZE["vocab"], shape).astype(np.int32)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("cf", [DROP_CF, 8.0])
def test_forward_matches_jax(model, dispatch, cf):
    jcfg, cfg = _configs(dispatch=dispatch, capacity_factor=cf)
    toks = _tokens(1, (3, 100))
    got = tf.forward(model["params"], cfg, {"tokens": _tok(toks)})
    want = j_tf.forward(model["jparams"], jcfg,
                        {"tokens": jnp.asarray(toks)})
    assert got.shape == (3, 100, SIZE["vocab"])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_decode_steps_match_jax(model):
    """Each decode step (groups of B tokens) against the reference's, the
    caches written in place against its returned caches, and the last
    step against the forward (the reduced factor drops nothing, so the
    two groupings route alike)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    toks = _tokens(2)
    step = jax.jit(j_tf.decode_step, static_argnums=1)
    jcache = j_tf.init_cache(jcfg, B, S + 2)
    cache = tf.init_cache(cfg, B, S + 2, device="cpu")
    k_buffer = cache["l0"]["k"]
    for t in range(S):
        want, jcache = step(model["jparams"], jcfg, jcache,
                            jnp.asarray(toks[:, t:t + 1]), t)
        got, cache = tf.decode_step(model["params"], cfg, cache,
                                    _tok(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert cache["l0"]["k"] is k_buffer
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache["l0"][key]),
                                   _np(jcache["l0"][key]), **TOL)
    full = tf.forward(model["params"], cfg, {"tokens": _tok(toks)})
    np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, -1]), **TOL)


@pytest.mark.parametrize("cf", [DROP_CF, 8.0])
def test_loss_and_gradients_match_jax(model, cf):
    """`loss_fn` and every gradient leaf (router, stacked experts,
    attention, norms, tables) against `jax.value_and_grad`, with and
    without dropped slots."""
    jcfg, cfg = _configs(capacity_factor=cf)
    toks = _tokens(3, (2, 64))
    batch = {"tokens": toks, "labels": _tokens(4, (2, 64))}
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
    assert float(np.abs(got["blocks.l0.moe.router.w"]).max()) > 0


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_prefill_and_decode_steps_run_both_models(arch):
    """`launch.steps`' prefill and decode steps on the reduced qwen3-moe
    and deepseek-v3 (MLA): the prefill against the reference's forward,
    a decode step against the prefill's first position."""
    from repro_torch.launch import steps
    jcfg, cfg = _configs(arch)
    arrays = _draw_params(jcfg, seed=9)
    params = transformer_params_from_arrays(arrays, device="cpu")
    toks = _tokens(6)
    got = steps.make_prefill_step(cfg)(params, {"tokens": _tok(toks)})
    want = j_tf.forward(jax.tree.map(jnp.asarray, arrays), jcfg,
                        {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    cache = tf.init_cache(cfg, B, S, device="cpu")
    logits, _ = steps.make_decode_step(cfg)(params, cache,
                                            _tok(toks[:, :1]), 0)
    np.testing.assert_allclose(_np(logits), _np(got[:, :1]), **TOL)
