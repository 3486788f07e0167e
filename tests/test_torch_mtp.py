"""DeepSeek-V3's multi-token-prediction (MTP) head in the port against the
JAX package's, on the CPU: the reduced deepseek-v3-671b of
`test_torch_mla.py` (2 layers, d_model 64, MLA, 4 experts top-2 and a
shared one, vocab 256, float32) with its published `mtp_depth=1`.

* The `mtp` subtree ({proj, ln_h, ln_e, layer}: one unstacked layer of
  the last layer's kind) against `jax.eval_shape` of the reference's
  `init_params`, the reduced model and the full-width one (on the `meta`
  device), with the exact count: the reference's `param_count()` leaves
  out the head (and every norm scale); `active_param_count()` leaves
  the head out, as DeepSeek-V3 quotes its 37B.
* The conversion carries the head across; a key the head does not hold
  still raises by name.
* `loss_fn` with its MTP term and every gradient leaf, `mtp.*`
  included, against `jax.value_and_grad` of the reference's `loss_fn`
  (1e-5); remat on against off bitwise; the MTP layer outside the remat
  checkpoints; two `make_train_step` steps against a JAX step composed
  from `loss_fn` and `repro.optim.adamw`; the vlm family ignores the head,
  as the reference's loss does.

Footprint: the JAX reference is called only through `repro.models`,
`repro.configs` and `repro.optim.adamw`; full-width parameters exist only
as shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import transformer as j_tf
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import (adamw_state_from_arrays,
                                 transformer_params_from_arrays)
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

from test_torch_grad import TOL, flat
from test_torch_mla import SIZE, _draw_params

ARCH = "deepseek-v3-671b"
MTP_WEIGHT = 0.3


def _configs(**change):
    jcfg = dataclasses.replace(j_reduced(j_get_config(ARCH), **SIZE),
                               **change)
    cfg = dataclasses.replace(reduced(get_config(ARCH), **SIZE), **change)
    return jcfg, cfg


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs()
    assert cfg.mtp_depth == jcfg.mtp_depth == 1
    arrays = _draw_params(jcfg, seed=13)
    rng = np.random.default_rng(14)
    batch = {k: rng.integers(0, SIZE["vocab"], (2, 17)).astype(np.int32)
             for k in ("tokens", "labels")}
    return dict(jcfg=jcfg, cfg=cfg, arrays=arrays,
                jparams=jax.tree.map(jnp.asarray, arrays),
                params=transformer_params_from_arrays(arrays, device="cpu"),
                batch=batch)


def _shapes(tree):
    return jax.tree.map(lambda t: tuple(t.shape), tree)


def _uncounted(cfg):
    """Leaves the reference's `param_count()` leaves out: the norm scales
    (ln1, ln2, ln_f, MLA's q_norm and kv_norm) and the whole MTP head."""
    L, d = cfg.num_layers, cfg.d_model
    per_layer = 2 * d + cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank
    return L * per_layer + d + cfg.mtp_param_count()


# ---------------------------------------------------------------------------
# The tree, the counts, the conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_mtp_tree_and_exact_count_match_jax(width):
    if width == "full":
        cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    else:
        jcfg, cfg = _configs()
    params = tf.init_params(cfg, device="meta")
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    assert _shapes(params) == _shapes(shapes)
    m = params["mtp"]
    d = cfg.d_model
    assert tuple(m["proj"]["w"].shape) == (2 * d, d)
    assert sorted(m["layer"]) == sorted(params["blocks"]["l0"])
    # One layer, no leading group axis.
    assert tuple(m["layer"]["ln1"]["scale"].shape) == (d,)
    n = sum(t.numel() for t in jax.tree.leaves(params))
    n_mtp = sum(t.numel() for t in jax.tree.leaves(m))
    assert n == cfg.param_count() == jcfg.param_count() + _uncounted(cfg)
    assert n_mtp == cfg.mtp_param_count()
    e = cfg.moe
    skipped = cfg.num_layers * (e.num_experts - e.top_k) * 3 * d \
        * e.d_expert_ff
    assert cfg.active_param_count() == n - n_mtp - skipped
    if width == "full":
        assert round(n / 1e9, 1) == 715.4 and round(n_mtp / 1e9, 2) == 11.61
        assert round(cfg.active_param_count() / 1e9, 1) == 37.6


def test_no_mtp_head_without_mtp_depth():
    _, cfg = _configs(mtp_depth=0)
    params = tf.init_params(cfg, device="meta")
    assert "mtp" not in params
    assert sum(t.numel() for t in jax.tree.leaves(params)) == \
        cfg.param_count()


def test_conversion_carries_the_head(model):
    got, want = flat(model["params"]), flat(model["arrays"])
    assert got.keys() == want.keys()
    assert any(k.startswith("mtp.layer.moe.") for k in got)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    bad = {"mtp": {"proj": {"w": np.zeros((8, 4), np.float32)},
                   "extra": {"w": np.zeros((4,), np.float32)}}}
    with pytest.raises(NotImplementedError, match="'extra'.*'mtp'"):
        transformer_params_from_arrays(bad, device="cpu")


def test_compute_params_casts_the_head_like_the_stack(model):
    cfg = dataclasses.replace(model["cfg"], dtype="bfloat16")
    m = tf.compute_params(model["params"], cfg)["mtp"]
    assert m["proj"]["w"].dtype == torch.bfloat16
    assert m["layer"]["moe"]["w_gate"].dtype == torch.bfloat16
    assert m["layer"]["moe"]["router"]["w"].dtype == torch.float32
    assert m["ln_h"]["scale"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------
def _value_and_grad(params, cfg, batch):
    return value_and_grad(lambda p, b: tf.loss_fn(p, cfg, b), params,
                          {k: torch.as_tensor(v) for k, v in batch.items()})


def test_loss_with_mtp_and_every_gradient_leaf_match_jax(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    loss, grads = _value_and_grad(model["params"], cfg, model["batch"])
    jb = {k: jnp.asarray(v) for k, v in model["batch"].items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_tf.loss_fn(p, jcfg, jb)))(model["jparams"])
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    got, want = flat(grads), flat(jgrads)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    for key in ("mtp.proj.w", "mtp.ln_h.scale", "mtp.ln_e.scale",
                "mtp.layer.attn.kv_norm.scale", "mtp.layer.moe.router.w"):
        assert float(np.abs(got[key]).max()) > 0, key


def test_mtp_term_is_three_tenths_of_its_cross_entropy(model):
    """The loss less the next-token loss (the same model without the
    head) is 0.3 times the cross-entropy of the t + 2 predictions, which
    the reference weighs the same way."""
    cfg = model["cfg"]
    tb = {k: torch.as_tensor(v) for k, v in model["batch"].items()}
    with torch.no_grad():
        full = tf.loss_fn(model["params"], cfg, tb)
        base = tf.loss_fn(model["params"],
                          dataclasses.replace(cfg, mtp_depth=0), tb)
    jb = {k: jnp.asarray(v) for k, v in model["batch"].items()}
    jbase = j_tf.loss_fn(model["jparams"],
                         dataclasses.replace(model["jcfg"], mtp_depth=0), jb)
    np.testing.assert_allclose(float(base), float(jbase), **TOL)
    mtp = (float(full) - float(base)) / MTP_WEIGHT
    assert np.isfinite(mtp) and mtp > 0
    jfull = j_tf.loss_fn(model["jparams"], model["jcfg"], jb)
    np.testing.assert_allclose(mtp, (float(jfull) - float(jbase))
                               / MTP_WEIGHT, rtol=1e-4)


def test_remat_on_and_off_are_bitwise_and_skip_the_mtp_layer(model,
                                                             monkeypatch):
    """Remat changes no bit of the loss or any gradient; it recomputes the
    stack's layers and not the MTP layer, which the reference applies
    outside its checkpoint: 4L + 1 norms and the MTP layer's 4 and its
    two input norms without remat, 4L more with it (MLA: ln1, q_norm,
    kv_norm, ln2 a layer)."""
    calls = []
    real = rms_ops.rmsnorm_ref
    monkeypatch.setattr(rms_ops, "rmsnorm_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = model["cfg"]
    L = cfg.num_layers
    out = {}
    for remat in (False, True):
        calls.clear()
        out[remat] = _value_and_grad(
            model["params"], dataclasses.replace(cfg, remat=remat),
            model["batch"])
        assert len(calls) == 4 * L + 1 + 4 + 2 + (4 * L if remat else 0)
    assert torch.equal(out[False][0], out[True][0])
    a, b = flat(out[False][1]), flat(out[True][1])
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_two_train_steps_match_jax(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    oc = adamw.AdamWConfig(total_steps=10)
    joc = j_adamw.AdamWConfig(total_steps=10)

    def jax_step(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: j_tf.loss_fn(p, jcfg, batch))(params)
        updates, opt = j_adamw.adamw_update(grads, opt, params, joc)
        return j_adamw.apply_updates(params, updates), opt, loss

    jstep = jax.jit(jax_step)
    jp, jo = model["jparams"], j_adamw.adamw_init(model["jparams"], joc)
    p = jax.tree.map(torch.clone, model["params"])
    o = adamw_state_from_arrays(jax.tree.map(np.asarray, jo), device="cpu")
    step = make_train_step(cfg, oc)
    for i in range(2):
        batch = synthetic_batch(cfg, ShapeCell("t", 16, 2, "train"), step=i)
        jp, jo, jloss = jstep(jp, jo, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        p, o, loss = step(p, o, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want = flat(p), flat(jp)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    assert not np.array_equal(got["mtp.proj.w"],
                              flat(model["params"])["mtp.proj.w"])


def test_the_vlm_family_ignores_the_head():
    """The reference's loss reads the MTP head for every family but the
    vlm: a reduced qwen2-vl with `mtp_depth=1` has the head in its tree
    and the loss of the same model without it, as the reference's."""
    jcfg = dataclasses.replace(
        j_reduced(j_get_config("qwen2-vl-72b"), layers=2, d_model=64,
                  vocab=256), mtp_depth=1)
    cfg = dataclasses.replace(
        reduced(get_config("qwen2-vl-72b"), layers=2, d_model=64, vocab=256),
        mtp_depth=1)
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(15)
    arrays = jax.tree.map(lambda s: (rng.standard_normal(s.shape) / (
        np.sqrt(s.shape[-2]) if len(s.shape) > 1 else 10.0)).astype(
            np.float32), shapes)
    params = transformer_params_from_arrays(arrays, device="cpu")
    assert "mtp" in params
    batch = synthetic_batch(cfg, ShapeCell("t", 16, 2, "train"), step=0)
    with torch.no_grad():
        got = tf.loss_fn(params, cfg, {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
        base = tf.loss_fn(params, dataclasses.replace(cfg, mtp_depth=0),
                          {k: torch.as_tensor(v) for k, v in batch.items()})
    want = j_tf.loss_fn(jax.tree.map(jnp.asarray, arrays), jcfg,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(got) == float(base)
    np.testing.assert_allclose(float(got), float(want), **TOL)
