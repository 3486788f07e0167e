"""Gradients of the port's training path against the JAX package's, on
the CPU.

* The closed-form backwards of rmsnorm and flash attention
  (`kernels/*/grad.py`, which the kernels' autograd Functions call on the
  card) against `jax.vjp` of `repro.models.common.rmsnorm` and
  `repro.models.attention.flash_attention_jnp`, and against torch
  autograd through the plain versions: causal and not, GQA, `q_offset`,
  Sq and Skv crossing a 1024-key chunk, Dv != Dh; 1e-5 in f32.
* `loss_fn` and its gradient against `jax.value_and_grad` of
  `repro.models.transformer.loss_fn` on the reduced stablelm-3b, 1e-5.
* Remat on against off: bitwise.

Footprint: the JAX reference is called only through `repro.models`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import transformer as j_tf
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels.flash_attention.grad import attention_bwd
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.rmsnorm.grad import rmsnorm_bwd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import common
from repro_torch.models import transformer as tf

TOL = dict(rtol=1e-5, atol=1e-5)

# Shared with test_torch_optim.py: the reduced stablelm-3b of
# test_torch_serve.py (2 layers, d 128, 4 heads of 32 over 2 kv heads,
# vocab 512, float32) in both packages from the same numpy draws, and
# the integration tests' config (d 64, vocab 256).
SIZE = dict(layers=2, d_model=128, vocab=512)
INTEGRATION = dict(layers=2, d_model=64)


def configs(**size):
    return (j_reduced(j_get_config("stablelm-3b"), **size),
            reduced(get_config("stablelm-3b"), **size))


def draw_params(jcfg, seed):
    """numpy draws in the shapes of the JAX tree: weights N(0, 1/fan_in),
    tables N(0, 0.02²), norm scales 1 + N(0, 0.1²)."""
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


def both_params(jcfg, seed=0):
    """(JAX tree, port tree) of the same draws."""
    arrays = draw_params(jcfg, seed)
    return (jax.tree.map(jnp.asarray, arrays),
            transformer_params_from_arrays(arrays, device="cpu"))


def to_np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def flat(tree, prefix=""):
    """{dotted key: numpy array} of a nested dict of either package."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = to_np(v)
    return out



# (B, Sq, Skv, H, KV, Dh, Dv, causal, q_offset)
FA_CASES = [
    (1, 1100, 1100, 4, 2, 16, 16, True, 0),      # crosses a chunk, GQA
    (2, 37, 1030, 2, 1, 8, 12, False, 0),        # non-causal, Dv != Dh
    (1, 50, 1100, 2, 2, 16, 8, True, 1050),      # q_offset into chunk 2
    (2, 64, 64, 4, 4, 32, 32, True, 0),          # one chunk, MHA
    (1, 40, 72, 6, 2, 16, 24, True, 32),         # offset causal, GQA 3
]


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_attention_bwd_matches_jax_vjp_and_autograd(case):
    B, Sq, Skv, H, KV, Dh, Dv, causal, qo = case
    rng = np.random.default_rng(Sq + Skv)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, H, Dh), (B, Skv, KV, Dh), (B, Skv, KV, Dv), (B, Sq, H, Dv)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attention_ref(tq, tk, tv, causal=causal, q_offset=qo)
    out.backward(torch.tensor(do))
    with torch.no_grad():
        lse = attention_lse_ref(tq, tk, causal, qo)
        got = attention_bwd(tq, tk, tv, out, lse, torch.tensor(do),
                            causal=causal, q_offset=qo)
    _, vjp = jax.vjp(lambda a, b, c: j_attn.flash_attention_jnp(
        a, b, c, causal=causal, q_offset=qo), q, k, v)
    want_jax = vjp(jnp.asarray(do))
    for name, g, a, j in zip("qkv", got, (tq.grad, tk.grad, tv.grad),
                             want_jax):
        np.testing.assert_allclose(g.numpy(), a.numpy(), **TOL,
                                   err_msg=f"d{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL,
                                   err_msg=f"d{name} vs jax.vjp")


def test_attention_lse_is_the_softmax_normaliser():
    """exp(S − LSE) sums to one over each row's live keys."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.standard_normal((1, 9, 2, 8)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((1, 12, 1, 8)), dtype=torch.float32)
    lse = attention_lse_ref(q, k, causal=True, q_offset=3)
    s = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) / np.sqrt(8)
    dead = torch.arange(12)[None, :] > (3 + torch.arange(9))[:, None]
    p = torch.exp(s - lse[..., None]).masked_fill(dead, 0.0)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("shape", [(6, 40), (2, 3, 128)])
def test_rmsnorm_bwd_matches_jax_vjp_and_autograd(shape):
    rng = np.random.default_rng(len(shape))
    x = (1.5 * rng.standard_normal(shape)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    tx, ts = torch.tensor(x, requires_grad=True), torch.tensor(
        s, requires_grad=True)
    rmsnorm_ref(tx, ts).backward(torch.tensor(dy))
    dx, ds = rmsnorm_bwd(tx.detach(), ts.detach(), torch.tensor(dy))
    _, vjp = jax.vjp(lambda a, b: j_common.rmsnorm({"scale": b}, a), x, s)
    jdx, jds = vjp(jnp.asarray(dy))
    for name, g, a, j in (("dx", dx, tx.grad, jdx), ("ds", ds, ts.grad, jds)):
        np.testing.assert_allclose(g.numpy(), a.numpy(), **TOL,
                                   err_msg=f"{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL,
                                   err_msg=f"{name} vs jax.vjp")


def test_cross_entropy_matches_jax_with_ignored_labels():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    labels[0, 2] = labels[1, 5] = -1
    got = common.cross_entropy(torch.tensor(logits), torch.tensor(labels))
    want = j_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = configs(**SIZE)
    jparams, params = both_params(jcfg, seed=0)
    batch = synthetic_batch(cfg, ShapeCell("t", 24, 2, "train"), step=0)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                batch=batch)


def _port_value_and_grad(params, cfg, batch):
    return value_and_grad(lambda p, b: tf.loss_fn(p, cfg, b), params,
                          {k: torch.as_tensor(v) for k, v in batch.items()})


def test_loss_fn_and_gradient_match_jax(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    loss, grads = _port_value_and_grad(model["params"], cfg, model["batch"])
    jb = {k: jnp.asarray(v) for k, v in model["batch"].items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: j_tf.loss_fn(p, jcfg, jb))(model["jparams"])
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    got, want = flat(grads), flat(jgrads)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_remat_on_and_off_are_bitwise(model):
    cfg = model["cfg"]
    assert not cfg.remat
    off = _port_value_and_grad(model["params"], cfg, model["batch"])
    on = _port_value_and_grad(model["params"],
                              dataclasses.replace(cfg, remat=True),
                              model["batch"])
    assert torch.equal(off[0], on[0])
    a, b = flat(off[1]), flat(on[1])
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_remat_recomputes_each_layer_in_the_backward(model, monkeypatch):
    """With remat, each layer's forward runs again in the backward: the
    norms run 4L + 1 times a step (2L + 1 without)."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    calls = []
    real = rms_ops.rmsnorm_ref
    monkeypatch.setattr(rms_ops, "rmsnorm_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = model["cfg"]
    L = cfg.num_layers
    for remat, want in ((False, 2 * L + 1), (True, 4 * L + 1)):
        calls.clear()
        _port_value_and_grad(model["params"],
                             dataclasses.replace(cfg, remat=remat),
                             model["batch"])
        assert len(calls) == want, remat
