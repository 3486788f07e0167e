"""The port's encoder-decoder (whisper-large-v3) against the JAX
package's `repro.models.encdec`, on the CPU, at a reduced whisper (2
encoder and 2 decoder layers, d_model 128, 4 heads of 32 over 2 kv heads,
16 frames, vocab 512, float32), from the same numpy-seeded parameters
carried over by `repro_torch.convert`.

On the CPU the port's rmsnorm and flash attention take their kernels'
plain versions; the JAX model takes its jnp paths. Tolerances: 1e-5
(rtol and atol) on float32 activations, logits, losses and gradients, as
`test_torch_serve.py`; the decode steps against the teacher-forced
forward at 2e-2, the reference's own bound
(`tests/test_models.py:test_whisper_decode_matches_forward`); remat on
and off bitwise; the data pipeline bit for bit.

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
from repro.models import encdec as j_encdec
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import steps
from repro_torch.launch.train import train
from repro_torch.models import encdec
from repro_torch.optim.adamw import AdamWConfig, adamw_init

ARCH = "whisper-large-v3"
SIZE = dict(layers=2, d_model=128, vocab=512)
B, S, STEPS = 2, 8, 8
TOL = dict(rtol=1e-5, atol=1e-5)
WHISPER_PARAMS = 1_954_032_640          # every leaf, norms included
WHISPER_NORMS = 207_360                 # (2·32 + 3·32 + 2) · 1280


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
    the table N(0, 0.02²), norm scales 1 + N(0, 0.1²)."""
    shapes = jax.eval_shape(
        lambda: j_encdec.init_params(jcfg, jax.random.PRNGKey(0)))
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
    jcfg = j_reduced(j_get_config(ARCH), **SIZE)
    cfg = reduced(get_config(ARCH), **SIZE)
    arrays = _draw_params(jcfg, seed=0)
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, SIZE["vocab"], (B, S)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, arrays)
    params = transformer_params_from_arrays(arrays, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, arrays=arrays, jparams=jparams,
                params=params, frames=frames, tokens=tokens,
                jenc=j_encdec.encode(jparams, jcfg, jnp.asarray(frames)))


def _batch(model):
    return {"frames": torch.as_tensor(model["frames"]),
            "tokens": torch.as_tensor(model["tokens"], dtype=torch.long)}


def _jbatch(model):
    return {"frames": jnp.asarray(model["frames"]),
            "tokens": jnp.asarray(model["tokens"])}


# ---------------------------------------------------------------------------
# Configs, shapes and conversion
# ---------------------------------------------------------------------------
def test_configs_match_jax_field_for_field(model):
    for cfg, jcfg in ((get_config(ARCH), j_get_config(ARCH)),
                      (model["cfg"], model["jcfg"])):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    cfg = model["cfg"]
    assert (cfg.family, cfg.encoder_layers, cfg.encoder_seq) == \
        ("encdec", 2, 16)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.dh) == (4, 2, 32)


def test_full_width_tree_and_parameter_count_from_shapes():
    """whisper-large-v3 at full width, from shapes alone: the port's tree
    on the `meta` device against the JAX tree from `jax.eval_shape`, and
    the exact count of every leaf."""
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    params = encdec.init_params(cfg, device="meta")
    shapes = jax.eval_shape(
        lambda: j_encdec.init_params(jcfg, jax.random.PRNGKey(0)))
    got = jax.tree.map(lambda t: tuple(t.shape), params)
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert got == want
    n = sum(t.numel() for t in jax.tree.leaves(params))
    assert n == cfg.param_count() == WHISPER_PARAMS
    assert n == jcfg.param_count() + WHISPER_NORMS   # JAX skips the norms
    cache = encdec.init_cache(cfg, 8, 128, device="meta")
    jcache = jax.eval_shape(lambda: j_encdec.init_cache(jcfg, 8, 128))
    assert jax.tree.map(lambda t: tuple(t.shape), cache) == \
        jax.tree.map(lambda s: tuple(s.shape), jcache)
    assert cache["enc_k"].shape == (32, 8, 1500, 20, 64)


def test_convert_carries_the_encdec_tree(model):
    got, want = _flat(model["params"]), _flat(model["arrays"])
    assert got.keys() == want.keys()
    assert any(k.startswith("dec_blocks.xattn.") for k in got)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_model_module_and_step_builders_route_encdec(model):
    cfg = model["cfg"]
    assert steps.model_module(cfg) is encdec
    assert steps.model_module(reduced(get_config("stablelm-3b"))) \
        is not encdec
    got = steps.make_prefill_step(cfg)(model["params"], _batch(model))
    want = encdec.forward(model["params"], cfg, _batch(model))
    assert torch.equal(got, want)
    enc = encdec.encode(model["params"], cfg, _batch(model)["frames"])
    cache = encdec.start_cache(model["params"], cfg, enc, B, S)
    logits, cache = steps.make_decode_step(cfg)(
        model["params"], cache, _batch(model)["tokens"][:, :1], 0)
    assert logits.shape == (B, 1, SIZE["vocab"])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
def test_sinusoidal_positions_match_jax():
    from repro.models import common as j_common
    from repro_torch.models import common
    np.testing.assert_allclose(
        _np(common.sinusoidal_positions(37, 64)),
        _np(j_common.sinusoidal_positions(37, 64)), rtol=1e-6, atol=1e-6)


def test_encode_matches_jax(model):
    got = encdec.encode(model["params"], model["cfg"],
                        torch.as_tensor(model["frames"]))
    assert got.shape == (B, 16, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(model["jenc"]), **TOL)


def test_decode_and_forward_match_jax(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    enc = torch.tensor(np.asarray(model["jenc"]))
    got = encdec.decode(model["params"], cfg, _batch(model)["tokens"], enc)
    want = j_encdec.decode(model["jparams"], jcfg,
                           jnp.asarray(model["tokens"]), model["jenc"])
    assert got.shape == (B, S, SIZE["vocab"]) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    got = encdec.forward(model["params"], cfg, _batch(model))
    want = j_encdec.forward(model["jparams"], jcfg, _jbatch(model))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.fixture(scope="module")
def stepped(model):
    """STEPS decode steps of both packages from their start_cache, with
    each step's logits and cache (the port's copied, since it writes in
    place)."""
    cfg, jcfg, toks = model["cfg"], model["jcfg"], model["tokens"]
    enc = torch.tensor(np.asarray(model["jenc"]))
    cache = encdec.start_cache(model["params"], cfg, enc, B, STEPS + 4)
    jcache = j_encdec.start_cache(model["jparams"], jcfg, model["jenc"], B,
                                  STEPS + 4)
    start = ({k: v.clone() for k, v in cache.items()}, jcache)
    jstep = jax.jit(j_encdec.decode_step, static_argnums=1)
    out = []
    for t in range(STEPS):
        logits, cache = encdec.decode_step(
            model["params"], cfg, cache,
            torch.as_tensor(toks[:, t:t + 1], dtype=torch.long), t)
        jlogits, jcache = jstep(model["jparams"], jcfg, jcache,
                                jnp.asarray(toks[:, t:t + 1]), t)
        out.append((logits, {k: v.clone() for k, v in cache.items()},
                    jlogits, jcache))
    return start, out


def test_start_cache_matches_jax(stepped):
    (cache, jcache), _ = stepped
    assert cache.keys() == jcache.keys()
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **TOL,
                                   err_msg=key)
    assert float(cache["enc_k"].abs().max()) > 0.1


@pytest.mark.parametrize("t", range(STEPS))
def test_decode_step_logits_and_cache_match_jax(stepped, t):
    logits, cache, jlogits, jcache = stepped[1][t]
    assert logits.shape == (B, 1, SIZE["vocab"])
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    for key in cache:
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **TOL,
                                   err_msg=key)
    assert float(cache["k"][:, :, t].abs().max()) > 0     # written at t


def test_decode_steps_match_forward(model, stepped):
    """Each step's logits against the teacher-forced forward over the same
    tokens, at the reference's own bound."""
    full = encdec.forward(model["params"], model["cfg"], _batch(model))
    got = torch.cat([lg for lg, *_ in stepped[1]], dim=1)
    np.testing.assert_allclose(_np(got), _np(full), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def train_batch(model):
    return synthetic_batch(model["cfg"], ShapeCell("t", 12, 2, "train"), 0)


def _value_and_grad(params, cfg, batch):
    return steps.value_and_grad(
        steps.make_loss_fn(cfg), params,
        {k: torch.as_tensor(v) for k, v in batch.items()})


def test_synthetic_batch_matches_jax(model, train_batch):
    want = j_pipeline.synthetic_batch(
        model["jcfg"], JShapeCell("t", 12, 2, "train"), 0)
    assert train_batch.keys() == want.keys() == {"tokens", "labels",
                                                 "frames"}
    assert train_batch["frames"].shape == (2, 16, 128)
    for key in want:
        assert train_batch[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(train_batch[key], want[key],
                                      err_msg=key)


def test_loss_fn_and_every_gradient_match_jax(model, train_batch):
    jcfg, cfg = model["jcfg"], model["cfg"]
    loss, grads = _value_and_grad(model["params"], cfg, train_batch)
    jb = {k: jnp.asarray(v) for k, v in train_batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: j_encdec.loss_fn(p, jcfg, jb))(model["jparams"])
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    got, want = _flat(grads), _flat(jgrads)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    assert float(np.abs(got["enc_blocks.attn.wq.w"]).max()) > 0


def test_remat_on_and_off_are_bitwise(model, train_batch):
    cfg = model["cfg"]
    assert not cfg.remat
    off = _value_and_grad(model["params"], cfg, train_batch)
    on = _value_and_grad(model["params"], dataclasses.replace(cfg, remat=True),
                         train_batch)
    assert torch.equal(off[0], on[0])
    a, b = _flat(off[1]), _flat(on[1])
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_train_accepts_whisper(model, tmp_path):
    rep = train(model["cfg"], ShapeCell("t", 12, 2, "train"), 3,
                str(tmp_path), device="cpu")
    assert rep["steps"] == 3 and all(np.isfinite(rep["losses"]))
    assert set(rep["params"]) == set(model["params"])


# ---------------------------------------------------------------------------
# Kernel calls on the paths
# ---------------------------------------------------------------------------
def test_kernel_calls_on_the_encdec_paths(model, train_batch, monkeypatch):
    """What chip_smoke.py expects of the card: encode 2·L_enc + 1 RMSNorms
    and L_enc flash attentions; the teacher-forced decoder 3·L_dec + 1 and
    2·L_dec; a decode step 3·L_dec + 1 and none; a train step with remat
    4·L_enc + 1 + 6·L_dec + 1 and 2·L_enc + 4·L_dec."""
    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counted(rms_ops, "rmsnorm")
    counted(fa_ops, "flash_attention")
    cfg, params = model["cfg"], model["params"]
    Le, L = cfg.encoder_layers, cfg.num_layers

    def count(fn):
        for k in calls:
            calls[k] = 0
        out = fn()
        return out, dict(calls)

    enc, got = count(lambda: encdec.encode(params, cfg,
                                           _batch(model)["frames"]))
    assert got == {"rmsnorm": 2 * Le + 1, "flash_attention": Le}
    _, got = count(lambda: encdec.decode(params, cfg,
                                         _batch(model)["tokens"], enc))
    assert got == {"rmsnorm": 3 * L + 1, "flash_attention": 2 * L}
    cache = encdec.start_cache(params, cfg, enc, B, 4)
    _, got = count(lambda: encdec.decode_step(
        params, cfg, cache, _batch(model)["tokens"][:, :1], 0))
    assert got == {"rmsnorm": 3 * L + 1, "flash_attention": 0}
    rcfg = dataclasses.replace(cfg, remat=True)
    _, got = count(lambda: _value_and_grad(params, rcfg, train_batch))
    assert got == {"rmsnorm": 4 * Le + 1 + 6 * L + 1,
                   "flash_attention": 2 * Le + 4 * L}


def test_train_steps_move_every_leaf(model, train_batch):
    """Two in-place train steps (the schedule's first learning rate is
    0) move every leaf of the tree, the cross-attention's included."""
    cfg = model["cfg"]
    params = jax.tree.map(torch.clone, model["params"])
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    opt = adamw_init(params, opt_cfg)
    before = {k: v.copy() for k, v in _flat(params).items()}
    step = steps.make_train_step(cfg, opt_cfg)
    for _ in range(2):
        params, opt, loss = step(params, opt, train_batch)
        assert np.isfinite(loss)
    after = _flat(params)
    moved = [k for k in before if not np.array_equal(before[k], after[k])]
    assert set(moved) == set(before)
