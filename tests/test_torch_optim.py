"""The port's AdamW and train step against the JAX package's, on the CPU.

* `adamw_update`, `cosine_schedule`, `global_norm` against
  `repro.optim.adamw`, f32 and bf16 moments, at 1e-6; the in-place
  `adamw_step_` bitwise the functional update.
* Three train steps of the reduced stablelm-3b (the port's
  `make_train_step`, which updates in place) against the JAX step,
  composed here from `loss_fn`, `value_and_grad`, `adamw_update` and
  `apply_updates` (the body of `repro/launch/steps.py:51,83-84`): the
  parameters at rtol 1e-4, atol 1e-6, under the reference's own
  train-step test config (`AdamWConfig(total_steps=10)`). Adam divides
  by |g|: at a gradient of 6e-8 the two frameworks' f32 rounding
  (~1e-11 apart) moves a step by ~1e-4 of the learning rate, so at
  lr 1e-2 three steps part by up to 8.7e-6 at 3 of 16,384 elements.
* A non-finite loss raises before the step writes anything.
* `grad_accum=4` against 1 at the reference's own bounds
  (`tests/test_train_step.py:28-38`), and its refusal of a batch that
  does not divide.

Footprint: the JAX reference is called only through `repro.models` and
`repro.optim.adamw` (jax and numpy alone); `repro.launch` is not called.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as j_tf
from repro.optim import adamw as j_adamw
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import adamw_state_from_arrays
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw

from test_torch_grad import INTEGRATION, SIZE, both_params, configs, flat

OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)


def _tree(rng, dtype=np.float32):
    return {"a": {"w": rng.standard_normal((5, 7)).astype(dtype)},
            "b": rng.standard_normal((3,)).astype(dtype),
            "c": {"scale": (1 + 0.1 * rng.standard_normal(4)).astype(dtype)}}


def _torch(tree):
    return jax.tree.map(lambda a: torch.tensor(a), tree)


@pytest.mark.parametrize("step", [1, 2, 50, 100, 101, 5000, 10_000, 12_000])
def test_cosine_schedule_matches_reference(step):
    cfg = adamw.AdamWConfig()
    jcfg = j_adamw.AdamWConfig()
    got = adamw.cosine_schedule(cfg, torch.tensor(float(step)))
    want = j_adamw.cosine_schedule(jcfg, jnp.float32(step))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng)
    grads["b"] *= 40.0                 # the clip scale is below one
    cfg = adamw.AdamWConfig(moment_dtype=moments, **OPT)
    jcfg = j_adamw.AdamWConfig(moment_dtype=moments, **OPT)
    jstate = j_adamw.adamw_init(params, jcfg)
    state = adamw.adamw_init(_torch(params), cfg)
    jp, p = params, _torch(params)
    for _ in range(3):
        np.testing.assert_allclose(float(adamw.global_norm(_torch(grads))),
                                   float(j_adamw.global_norm(grads)),
                                   rtol=1e-6)
        jupd, jstate = j_adamw.adamw_update(grads, jstate, jp, jcfg)
        upd, state = adamw.adamw_update(_torch(grads), state, p, cfg)
        for got, want in ((upd, jupd), (state["m"], jstate["m"]),
                          (state["v"], jstate["v"])):
            g, w = flat(got), flat(want)
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6,
                                           atol=1e-9, err_msg=key)
        assert int(state["step"]) == int(jstate["step"])
        assert state["m"]["b"].dtype == getattr(torch, moments)
        jp = j_adamw.apply_updates(jp, jupd)
        p = adamw.apply_updates(p, upd)
        grads = jax.tree.map(lambda a: 0.7 * a + 0.01, grads)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_step_in_place_is_the_functional_update(moments):
    rng = np.random.default_rng(1)
    params, grads = _torch(_tree(rng)), _torch(_tree(rng))
    cfg = adamw.AdamWConfig(moment_dtype=moments, **OPT)
    state = adamw.adamw_init(params, cfg)
    upd, want = adamw.adamw_update(grads, state, params, cfg)
    want_p = adamw.apply_updates(params, upd)
    p = jax.tree.map(torch.clone, params)
    got = adamw.adamw_step_(p, grads, state, cfg)
    for a, b in ((p, want_p), (got["m"], want["m"]), (got["v"], want["v"])):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert torch.equal(x, y)
    assert got["m"]["a"]["w"] is state["m"]["a"]["w"]    # written in place
    assert int(got["step"]) == 1


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = configs(**SIZE)
    jparams, params = both_params(jcfg, seed=0)
    shape = ShapeCell("t", 24, 4, "train")
    batches = [synthetic_batch(cfg, shape, step=i) for i in range(3)]
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                batches=batches)


def _jax_step(jcfg, oc):
    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: j_tf.loss_fn(p, jcfg, batch))(params)
        updates, opt = j_adamw.adamw_update(grads, opt, params, oc)
        return j_adamw.apply_updates(params, updates), opt, loss
    return jax.jit(step)


def test_three_train_steps_match_jax(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    oc = adamw.AdamWConfig(total_steps=10)
    joc = j_adamw.AdamWConfig(total_steps=10)
    jstep = _jax_step(jcfg, joc)
    jp, jo = model["jparams"], j_adamw.adamw_init(model["jparams"], joc)
    p = jax.tree.map(torch.clone, model["params"])
    o = adamw_state_from_arrays(jax.tree.map(np.asarray, jo), device="cpu")
    step = make_train_step(cfg, oc)
    for batch in model["batches"]:
        jp, jo, jloss = jstep(jp, jo, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        p, o, loss = step(p, o, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want, start = flat(p), flat(jp), flat(model["params"])
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
        # The steps themselves (~1e-5 at this learning rate) agree too,
        # to 1 % or 1e-7 (the differences of parameters below 1 carry
        # their f32 rounding, 6e-8 an ulp at 1).
        np.testing.assert_allclose(got[key] - start[key],
                                   want[key] - start[key], rtol=1e-2,
                                   atol=1e-7, err_msg=key)
    gm, wm = flat(o["m"]), flat(jo["m"])
    for key in wm:
        np.testing.assert_allclose(gm[key], wm[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    assert int(o["step"]) == int(jo["step"]) == 3


def test_step_updates_in_place(model):
    cfg = model["cfg"]
    p = jax.tree.map(torch.clone, model["params"])
    o = adamw.adamw_init(p, adamw.AdamWConfig(**OPT))
    p1, o1, loss = make_train_step(cfg, adamw.AdamWConfig(**OPT))(
        p, o, model["batches"][0])
    assert p1 is p and isinstance(loss, float)
    assert o1["m"]["ln_f"]["scale"] is o["m"]["ln_f"]["scale"]
    assert int(o1["step"]) == 1 and o["m"]["ln_f"]["scale"].any()
    assert not torch.equal(p["ln_f"]["scale"],
                           model["params"]["ln_f"]["scale"])


@pytest.mark.parametrize("where", ["embed", "ln_f"])
def test_non_finite_loss_raises_before_anything_is_written(model, where):
    """A NaN in a parameter gives a NaN loss: the step raises and leaves
    every parameter and moment as it was, after a step that wrote."""
    cfg, oc = model["cfg"], adamw.AdamWConfig(**OPT)
    p = jax.tree.map(torch.clone, model["params"])
    o = adamw.adamw_init(p, oc)
    step = make_train_step(cfg, oc)
    p, o, _ = step(p, o, model["batches"][0])
    batch = model["batches"][1]
    if where == "embed":                 # the row of a token of the batch
        p["embed"]["table"][int(batch["tokens"][0, 0])] = float("nan")
    else:
        p["ln_f"]["scale"][3] = float("nan")
    before = [t.clone() for t in jax.tree.leaves((p, o))]
    with pytest.raises(FloatingPointError, match="nothing written"):
        step(p, o, batch)
    for a, b in zip(before, jax.tree.leaves((p, o))):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)
    assert int(o["step"]) == 1


def _accum_setup():
    jcfg, cfg = configs(**INTEGRATION)
    _, params = both_params(jcfg, seed=2)
    oc = adamw.AdamWConfig(total_steps=10)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 256, (8, 32)).astype(np.int32),
             "labels": rng.integers(0, 256, (8, 32)).astype(np.int32)}
    return cfg, params, oc, batch


def test_grad_accum_equivalent():
    cfg, params, oc, batch = _accum_setup()
    p1, p4 = (jax.tree.map(torch.clone, params) for _ in range(2))
    p1, _, l1 = make_train_step(cfg, oc, grad_accum=1)(
        p1, adamw.adamw_init(p1, oc), batch)
    p4, _, l4 = make_train_step(cfg, oc, grad_accum=4)(
        p4, adamw.adamw_init(p4, oc), batch)
    assert abs(float(l1) - float(l4)) < 1e-4
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_grad_accum_rejects_indivisible():
    cfg, params, oc, batch = _accum_setup()
    s3 = make_train_step(cfg, oc, grad_accum=3)
    with pytest.raises(AssertionError):
        s3(params, adamw.adamw_init(params, oc), batch)
