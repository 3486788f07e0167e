"""The port's Mamba-2 (SSD) path against the JAX package's, on the CPU, at
a reduced mamba2-780m (2 layers, d_model 64, d_in 128 in 8 heads of 16,
d_state 16, chunk 8, vocab 256, float32, tied embeddings), from the same
numpy-seeded parameters carried over by `repro_torch.convert`.

On the CPU the port's ssd_scan and rmsnorm take their kernels' plain
versions; the JAX model takes its inline `lax.scan` and jnp paths.
Tolerances: 1e-4 (rtol and atol) on float32 activations, states and
logits (chunked sums and exponentials in another order, through two
layers); greedy tokens exactly. The bfloat16 model is held at 0.05 (rtol
and atol on the logits): the two frameworks round to bfloat16 at other
places inside a layer.

Footprint: the JAX reference is called only through `repro.models`,
`repro.configs` and `repro.launch.serve`; nothing here sets threads,
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
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro_torch.configs import get_config, reduced
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

SIZE = dict(layers=2, d_model=64, vocab=256)
B, S, MAX_NEW = 2, 12, 3         # S = 12 at chunk 8: 2 chunks, 4 padded
TOL = dict(rtol=1e-4, atol=1e-4)
MAMBA2_780M_PARAMS = 780_148_992
# Leaves the JAX `param_count` skips: per layer the ln1 and gated-norm
# scales, conv_b and dt_bias; and the final norm.
JAX_UNCOUNTED = 48 * (1536 + 3072 + 3328 + 48) + 1536


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _tok(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _draw_params(jcfg, seed):
    """numpy draws in the shapes of the JAX tree: weights N(0, 1/fan_in),
    the table N(0, 0.02²), norm scales and D 1 + N(0, 0.1²), conv bias
    N(0, 0.1²); A_log and dt_bias put the decays per step near 0.95, so a
    chunk carries into the next (exp(dt·A) per chunk ≈ 0.7)."""
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(s.shape)
        if "scale" in name or "'D'" in name:
            out = 1.0 + 0.1 * z
        elif "table" in name:
            out = 0.02 * z
        elif "A_log" in name:
            out = -1.0 + 0.3 * z
        elif "dt_bias" in name:
            out = -2.0 + 0.3 * z
        elif "conv_b" in name:
            out = 0.1 * z
        else:
            out = z / np.sqrt(s.shape[-2])
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def model():
    jcfg = j_reduced(j_get_config("mamba2-780m"), **SIZE)
    cfg = reduced(get_config("mamba2-780m"), **SIZE)
    arrays = _draw_params(jcfg, seed=0)
    rng = np.random.default_rng(1)
    return dict(jcfg=jcfg, cfg=cfg, arrays=arrays,
                jparams=jax.tree.map(jnp.asarray, arrays),
                params=transformer_params_from_arrays(arrays, device="cpu"),
                tokens=rng.integers(0, SIZE["vocab"], (B, S)).astype(
                    np.int32))


@pytest.fixture(scope="module")
def jax_greedy(model):
    return j_serve.greedy_decode(model["jparams"], model["jcfg"],
                                 model["tokens"], MAX_NEW, S + MAX_NEW)


def _assert_same_config(cfg, jcfg):
    """Field by field: the port's SSMConfig is another class than the
    JAX package's, so `ssm` is compared by its fields."""
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "ssm":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name


# ---------------------------------------------------------------------------
# Configs and shapes
# ---------------------------------------------------------------------------
def test_reduced_config_matches_jax(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    _assert_same_config(cfg, jcfg)
    assert (cfg.num_kv_heads, cfg.d_ff, cfg.tie_embeddings) == (0, 0, True)
    assert ssm.ssm_dims(cfg) == j_ssm.ssm_dims(jcfg) == (128, 8, 16, 16)
    assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
        [j_tf.layer_kind(jcfg, i) for i in range(jcfg.num_layers)]


def test_full_width_parameter_count_from_shapes():
    """mamba2-780m at full width, from shapes alone: the port's tree on the
    `meta` device against the JAX tree from `jax.eval_shape`."""
    cfg, jcfg = get_config("mamba2-780m"), j_get_config("mamba2-780m")
    _assert_same_config(cfg, jcfg)
    params = tf.init_params(cfg, device="meta")
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    got = jax.tree.map(lambda t: tuple(t.shape), params)
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert got == want
    assert "unembed" not in params
    n = sum(t.numel() for t in jax.tree.leaves(params))
    assert n == cfg.param_count() == MAMBA2_780M_PARAMS
    assert n == jcfg.param_count() + JAX_UNCOUNTED == \
        jcfg.param_count() + 384_768
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(params))
    cache = tf.init_cache(cfg, 8, 400, device="meta")
    jcache = jax.eval_shape(lambda: j_tf.init_cache(jcfg, 8, 400))
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        cache) == \
        jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jcache)


def test_compute_params_keeps_the_ssm_f32_leaves(model):
    cfg = dataclasses.replace(model["cfg"], dtype="bfloat16")
    cp = tf.compute_params(model["params"], cfg)
    kept = set()
    for path, t in jax.tree_util.tree_leaves_with_path(cp):
        leaf = path[-1].key
        if leaf in ("scale", "A_log", "D", "dt_bias"):
            assert t.dtype == torch.float32, leaf
            kept.add(leaf)
        else:
            assert t.dtype == torch.bfloat16, leaf
    assert kept == {"scale", "A_log", "D", "dt_bias"}


# ---------------------------------------------------------------------------
# The SSD block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G,h0", [(1, False), (2, False), (2, True)])
def test_ssd_chunked_matches_jax(G, h0):
    """Random inputs, 3 chunks of 8; G = 2 groups over 4 heads (where
    `jnp.repeat` and `Tensor.repeat` would differ); an initial state."""
    rng = np.random.default_rng(10 + G + 2 * h0)
    Bz, Sz, H, P, N, Q = 2, 24, 4, 8, 16, 8
    xh = rng.normal(size=(Bz, Sz, H, P)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((Bz, Sz, H))).astype(np.float32)
    A = -np.exp(rng.normal(-0.5, 0.3, H)).astype(np.float32)
    Bm = rng.normal(size=(Bz, Sz, G, N)).astype(np.float32)
    Cm = rng.normal(size=(Bz, Sz, G, N)).astype(np.float32)
    hinit = rng.normal(size=(Bz, H, P, N)).astype(np.float32) if h0 else None
    y, hl = ssm.ssd_chunked(_t(xh), _t(dt), _t(A), _t(Bm), _t(Cm), Q,
                            h0=None if hinit is None else _t(hinit))
    jy, jhl = j_ssm.ssd_chunked(
        *(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)), Q,
        h0=None if hinit is None else jnp.asarray(hinit))
    assert y.shape == (Bz, Sz, H, P) and hl.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(hl), _np(jhl), **TOL)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("seq", [20, 6])
def test_ssm_apply_matches_jax(model, seq):
    """S = 20 at chunk 8 pads to 24 (dt = 0 on the padding); S = 6 is one
    chunk of 6."""
    x = np.random.default_rng(seq).normal(size=(B, seq, 64)).astype(
        np.float32)
    got = ssm.ssm_apply(tf._layer(model["params"]["blocks"]["l0"], 0)["ssm"],
                        _t(x), model["cfg"])
    want = j_ssm.ssm_apply(_layer0(model["jparams"]["blocks"]["l0"])["ssm"],
                           jnp.asarray(x), model["jcfg"])
    assert got.shape == (B, seq, 64)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_ssm_decode_steps_match_jax(model):
    """Four decode steps of one layer from a random state, the state
    updated in place in the port and returned anew by the reference."""
    rng = np.random.default_rng(5)
    cfg, jcfg = model["cfg"], model["jcfg"]
    p = tf._layer(model["params"]["blocks"]["l0"], 1)["ssm"]
    jp = jax.tree.map(lambda a: a[1], model["jparams"]["blocks"]["l0"])["ssm"]
    h = rng.normal(size=(B, 8, 16, 16)).astype(np.float32)
    conv = rng.normal(size=(B, 3, 128 + 32)).astype(np.float32)
    state = {"h": _t(h.copy()), "conv": _t(conv.copy())}
    jstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
    for k in range(4):
        x = rng.normal(size=(B, 1, 64)).astype(np.float32)
        y, new = ssm.ssm_decode(p, _t(x), cfg, state)
        jy, jstate = j_ssm.ssm_decode(jp, jnp.asarray(x), jcfg, jstate)
        assert new is state
        np.testing.assert_allclose(_np(y), _np(jy), **TOL)
        for key in ("h", "conv"):
            np.testing.assert_allclose(_np(state[key]), _np(jstate[key]),
                                       **TOL)


def test_ssm_init_state_matches_jax(model):
    state = ssm.ssm_init_state(model["cfg"], 3, torch.float32, "cpu")
    jstate = j_ssm.ssm_init_state(model["jcfg"], 3, jnp.float32)
    for key in ("h", "conv"):
        assert tuple(state[key].shape) == jstate[key].shape
        assert not state[key].any()


# ---------------------------------------------------------------------------
# The model and the serving path
# ---------------------------------------------------------------------------
def test_forward_matches_jax(model):
    got = tf.forward(model["params"], model["cfg"],
                     {"tokens": _tok(model["tokens"])})
    want = j_tf.forward(model["jparams"], model["jcfg"],
                        {"tokens": jnp.asarray(model["tokens"])})
    assert got.dtype == torch.float32 and got.shape == (B, S, 256)
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
        assert got.shape == (B, 1, 256)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(_np(cache["l0"][key]),
                                   _np(jcache["l0"][key]), **TOL)
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
    assert stats.batch_size_used == max_batch
    assert stats.latencies_s.shape == (B,) and stats.throughput_tok_s > 0


def test_kernel_calls_on_the_serving_path(model, monkeypatch):
    """What chip_smoke.py expects of the card: per batch, one forward and
    S + max_new - 1 decode steps, each with 2·L + 1 RMSNorms (ln1 and the
    gated norm per layer, and ln_f); ssd_scan once per layer of the
    forward, and never in a decode step."""
    calls = {"rmsnorm": 0, "ssd_scan": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counted(rms_ops, "rmsnorm")
    counted(ssd_ops, "ssd_scan")
    cfg = model["cfg"]
    L = cfg.num_layers
    tf.forward(model["params"], cfg, {"tokens": _tok(model["tokens"])})
    assert calls == {"rmsnorm": 2 * L + 1, "ssd_scan": L}
    calls.update(rmsnorm=0, ssd_scan=0)
    serve.greedy_decode(model["params"], cfg, model["tokens"], MAX_NEW,
                        S + MAX_NEW)
    assert calls == {"rmsnorm": (2 * L + 1) * (1 + S + MAX_NEW - 1),
                     "ssd_scan": L}


def test_bfloat16_forward_close_to_jax(model):
    """The card's activation dtype, on the CPU in both frameworks."""
    cfg = dataclasses.replace(model["cfg"], dtype="bfloat16")
    jcfg = dataclasses.replace(model["jcfg"], dtype="bfloat16")
    got = tf.forward(model["params"], cfg, {"tokens": _tok(model["tokens"])})
    want = j_tf.forward(model["jparams"], jcfg,
                        {"tokens": jnp.asarray(model["tokens"])})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=0.05, atol=0.05)
