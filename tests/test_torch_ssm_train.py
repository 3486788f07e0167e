"""Training the port's SSM and hybrid families against the JAX package's,
on the CPU.

* `ssd_scan_bwd_ref`, the plain version of the ssd_scan backward kernel,
  against torch autograd through `ssd_scan_ref` (dstates and dh0 bit
  for bit, ddecay at relative L2 1e-6: the same products summed in
  another order) and against `jax.vjp` of the JAX package's oracle
  `repro.kernels.ssd_scan.ref.ssd_scan_ref` (1e-5), with and without an
  initial state, with and without a gradient on h_last.
* `SSDScanFn`, the autograd Function the card runs, with the two kernel
  wrappers replaced by their plain versions (the wrappers themselves
  need the card): its gradients are autograd's through the plain version
  bit for bit, through `ssd_chunked` and a whole `loss_fn`, and a train
  step launches the forward 2L and the backward L times under remat.
* `loss_fn` and every gradient leaf of the reduced mamba2-780m (2
  layers) against `jax.value_and_grad` of the reference's `loss_fn` at
  `test_torch_grad.TOL` (1e-5); remat on against off bitwise; three
  `make_train_step` steps against a JAX step composed here from
  `loss_fn`, `adamw_update` and `apply_updates`, as `test_torch_optim.py`
  composes it; the kernel calls of a train step. The same checks run on
  the reduced jamba in `test_torch_hybrid_train.py`, whose 16-layer
  model is held at 1e-4 (see `DEEP_TOL`).

Parameters are the numpy draws of `test_torch_ssm.py` and
`test_torch_hybrid.py` (decays near 0.95 a step, so that every chunk
carries state into the next), carried over by `repro_torch.convert`.

Footprint: the JAX reference is called only through `repro.models`,
`repro.kernels`, `repro.configs` and `repro.optim.adamw`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ssd_scan_ref
from repro.models import transformer as j_tf
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import (adamw_state_from_arrays,
                                 transformer_params_from_arrays)
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

from test_torch_grad import TOL, flat
from test_torch_hybrid import _configs as jamba_configs
from test_torch_hybrid import _draw_params as jamba_draw
from test_torch_ssm import SIZE as MAMBA_SIZE
from test_torch_ssm import _draw_params as mamba_draw
from test_torch_ssm import _np, _t

DECAY_REL_L2 = 1e-6
# jamba at 16 layers: its float32 rounding grows through the layers'
# backward to 1.3e-5 relative L2 per leaf (4.6e-6 at 8 layers), and 3 of
# the embedding table's 16,384 gradient elements part from the
# reference's by 1.5e-5; as `test_torch_hybrid.py` holds that model's
# decode cache.
DEEP_TOL = dict(rtol=1e-4, atol=1e-4)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# The plain backward
# ---------------------------------------------------------------------------
def _scan_inputs(dims, seed, h0):
    rng = np.random.default_rng(seed)
    B, NC, H, P, N = dims
    states = rng.standard_normal(dims).astype(np.float32)
    dec = rng.uniform(0.3, 1.0, (B, NC, H)).astype(np.float32)
    hinit = rng.standard_normal((B, H, P, N)).astype(np.float32) \
        if h0 else None
    g_prev = rng.standard_normal(dims).astype(np.float32)
    g_last = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return states, dec, hinit, g_prev, g_last


SCAN_DIMS = (2, 5, 3, 8, 16)


@pytest.mark.parametrize("last", [False, True], ids=["g_last_none",
                                                     "g_last"])
@pytest.mark.parametrize("h0", [False, True], ids=["no_h0", "h0"])
def test_ssd_scan_bwd_ref_is_autograd_through_the_plain_version(h0, last):
    states, dec, hinit, g_prev, g_last = _scan_inputs(SCAN_DIMS, 1 + h0, h0)
    ts = torch.tensor(states, requires_grad=True)
    td = torch.tensor(dec, requires_grad=True)
    th = None if hinit is None else torch.tensor(hinit, requires_grad=True)
    h_prev, h_last = ssd_scan_ref(ts, td, th)
    outs, grads = [h_prev], [torch.tensor(g_prev)]
    if last:
        outs.append(h_last)
        grads.append(torch.tensor(g_last))
    inputs = [ts, td] + ([th] if h0 else [])
    want = torch.autograd.grad(outs, inputs, grads)
    ds, dd, dh = ssd_scan_bwd_ref(torch.tensor(g_prev),
                                  torch.tensor(g_last) if last else None,
                                  td.detach(), h_prev.detach(), h0)
    assert torch.equal(ds, want[0])
    assert _rel_l2(dd, want[1]) < DECAY_REL_L2
    if h0:
        assert torch.equal(dh, want[2])
    else:
        assert dh is None


@pytest.mark.parametrize("h0", [False, True], ids=["no_h0", "h0"])
def test_ssd_scan_bwd_ref_matches_jax_vjp(h0):
    states, dec, hinit, g_prev, g_last = _scan_inputs(SCAN_DIMS, 7 + h0, h0)
    if h0:
        (jh_prev, _), vjp = jax.vjp(j_ssd_scan_ref, states, dec, hinit)
    else:
        (jh_prev, _), vjp = jax.vjp(lambda s, d: j_ssd_scan_ref(s, d),
                                    states, dec)
    want = vjp((jnp.asarray(g_prev), jnp.asarray(g_last)))
    h_prev, _ = ssd_scan_ref(torch.tensor(states), torch.tensor(dec),
                             None if hinit is None else torch.tensor(hinit))
    np.testing.assert_allclose(_np(h_prev), _np(jh_prev), **TOL)
    got = ssd_scan_bwd_ref(torch.tensor(g_prev), torch.tensor(g_last),
                           torch.tensor(dec), h_prev, h0)
    for name, g, w in zip(("dstates", "ddecay", "dh0"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL, err_msg=name)


def test_ssd_scan_bwd_ref_without_any_chunk_gradient():
    """g_prev None (no chunk reads h_prev) and g_last given: the gradient
    of h_last alone, the decays' powers."""
    states, dec, hinit, _, g_last = _scan_inputs((1, 3, 2, 4, 4), 5, True)
    ts, td, th = (torch.tensor(a, requires_grad=True)
                  for a in (states, dec, hinit))
    h_prev, h_last = ssd_scan_ref(ts, td, th)
    want = torch.autograd.grad(h_last, (ts, td, th), torch.tensor(g_last))
    got = ssd_scan_bwd_ref(None, torch.tensor(g_last), td.detach(),
                           h_prev.detach(), True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert _rel_l2(got[1], want[1]) < DECAY_REL_L2


# ---------------------------------------------------------------------------
# SSDScanFn, with the kernel wrappers replaced by their plain versions
# ---------------------------------------------------------------------------
@pytest.fixture()
def plain_kernels(monkeypatch):
    """`ops.ssd_scan`'s kernel route on the CPU: SSDScanFn with the two
    wrappers replaced by the plain versions, each call counted on the
    wrapper's `.launches` as the wrapper counts its launch."""
    counts = {"fwd": 0, "bwd": 0}

    def fwd(*a):
        counts["fwd"] += 1
        return ssd_scan_ref(*a)

    def bwd(*a):
        counts["bwd"] += 1
        return ssd_scan_bwd_ref(*a)

    monkeypatch.setattr(ssd_ops, "ssd_scan_cuda", fwd)
    monkeypatch.setattr(ssd_ops, "ssd_scan_bwd_cuda", bwd)
    real = ssd_ops.ssd_scan
    monkeypatch.setattr(ssd_ops, "ssd_scan", lambda *a, use_kernel=None:
                        real(*a, use_kernel=use_kernel is None))
    return counts


@pytest.mark.parametrize("h0", [False, True], ids=["no_h0", "h0"])
def test_ssd_scan_fn_gradients_are_plain_autograd_bitwise(plain_kernels, h0):
    states, dec, hinit, g_prev, g_last = _scan_inputs(SCAN_DIMS, 3, h0)
    got, want = [], []
    for kernel in (True, False):
        inputs = [torch.tensor(a, requires_grad=True)
                  for a in (states, dec, hinit) if a is not None]
        h_prev, h_last = ssd_ops.ssd_scan(
            *inputs[:2], inputs[2] if h0 else None,
            use_kernel=None if kernel else False)
        (got if kernel else want).append(torch.autograd.grad(
            (h_prev, h_last), inputs,
            (torch.tensor(g_prev), torch.tensor(g_last))))
    assert plain_kernels == {"fwd": 1, "bwd": 1}
    (g,), (w,) = got, want
    assert torch.equal(g[0], w[0]) and _rel_l2(g[1], w[1]) < DECAY_REL_L2
    if h0:
        assert torch.equal(g[2], w[2])


def test_ssd_chunked_gradient_through_ssd_scan_fn(plain_kernels):
    """Through `ssd_chunked` (h_last unused, as in `ssm_apply`: autograd
    passes no gradient for it): every input's gradient as autograd's
    through the plain version."""
    rng = np.random.default_rng(12)
    Bz, Sz, H, P, N, G, Q = 2, 24, 4, 8, 16, 2, 8
    arrays = (rng.normal(size=(Bz, Sz, H, P)),
              0.05 + 0.1 * rng.random((Bz, Sz, H)),
              -np.exp(rng.normal(-0.5, 0.3, H)),
              rng.normal(size=(Bz, Sz, G, N)),
              rng.normal(size=(Bz, Sz, G, N)))
    dy = torch.tensor(rng.normal(size=(Bz, Sz, H, P)), dtype=torch.float32)
    grads = []
    for kernel in (None, False):
        inputs = [_t(a).requires_grad_() for a in arrays]
        y, _ = ssm.ssd_chunked(*inputs, Q, use_kernel=kernel)
        grads.append(torch.autograd.grad(y, inputs, dy))
    assert plain_kernels == {"fwd": 1, "bwd": 1}
    for name, g, w in zip(("xh", "dt", "A", "Bm", "Cm"), *grads):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7, msg=name)


# ---------------------------------------------------------------------------
# The models: loss, gradients, remat, train steps (the checks, which
# test_torch_hybrid_train.py runs on jamba too)
# ---------------------------------------------------------------------------
def _mamba(seed=0):
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    jcfg = j_reduced(j_get_config("mamba2-780m"), **MAMBA_SIZE)
    cfg = reduced(get_config("mamba2-780m"), **MAMBA_SIZE)
    return jcfg, cfg, mamba_draw(jcfg, seed)


def _jamba(layers, seed=0):
    jcfg, cfg = jamba_configs(layers)
    return jcfg, cfg, jamba_draw(jcfg, seed)


MODELS = {"mamba2": _mamba, "jamba8": lambda: _jamba(8),
          "jamba16": lambda: _jamba(16)}
_BUILT = {}


def build(name):
    """(JAX config, port config, numpy draws, JAX tree, port tree, batch)
    of a model, once per process; the batch is 2 x 20 tokens, at chunk 8
    three chunks, the last padded by 4."""
    if name not in _BUILT:
        jcfg, cfg, arrays = MODELS[name]()
        rng = np.random.default_rng(4)
        batch = {k: rng.integers(0, cfg.vocab_size, (2, 20)).astype(
            np.int32) for k in ("tokens", "labels")}
        _BUILT[name] = dict(
            name=name, jcfg=jcfg, cfg=cfg, arrays=arrays,
            jparams=jax.tree.map(jnp.asarray, arrays),
            params=transformer_params_from_arrays(arrays, device="cpu"),
            batch=batch)
    return _BUILT[name]


def _value_and_grad(params, cfg, batch):
    return value_and_grad(lambda p, b: tf.loss_fn(p, cfg, b), params,
                          {k: torch.as_tensor(v) for k, v in batch.items()})


def check_loss_and_gradients(m):
    jcfg, cfg = m["jcfg"], m["cfg"]
    loss, grads = _value_and_grad(m["params"], cfg, m["batch"])
    jb = {k: jnp.asarray(v) for k, v in m["batch"].items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: j_tf.loss_fn(p, jcfg, jb))(m["jparams"])
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    got, want = flat(grads), flat(jgrads)
    assert got.keys() == want.keys()
    tol = DEEP_TOL if cfg.num_layers > 8 else TOL
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **tol, err_msg=key)
    # The gradient reaches the SSM's own f32 leaves through the scan.
    for leaf in ("A_log", "dt_bias", "D", "conv_w"):
        assert float(np.abs(got[f"blocks.l0.ssm.{leaf}"]).max()) > 0, leaf


def check_remat_bitwise(m):
    cfg = m["cfg"]
    off = _value_and_grad(m["params"], dataclasses.replace(
        cfg, remat=False), m["batch"])
    on = _value_and_grad(m["params"], dataclasses.replace(
        cfg, remat=True), m["batch"])
    assert torch.equal(off[0], on[0])
    a, b = flat(off[1]), flat(on[1])
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _jax_step(jcfg, oc):
    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: j_tf.loss_fn(p, jcfg, batch))(params)
        updates, opt = j_adamw.adamw_update(grads, opt, params, oc)
        return j_adamw.apply_updates(params, updates), opt, loss
    return jax.jit(step)


def check_three_train_steps(m):
    """`make_train_step` on `synthetic_batch`'s batches (4 x 24 tokens:
    three chunks) against the JAX step: the losses at 1e-5, the
    parameters at `test_torch_optim.py`'s bounds, and each leaf's three
    steps at relative L2 1e-3 (elementwise, a parameter whose gradient is
    near 0 moves by Adam's m / √v of its rounding: one of 18,944 elements
    of jamba's in_proj stepped 7 % apart, 2.5e-7)."""
    jcfg, cfg = m["jcfg"], m["cfg"]
    oc = adamw.AdamWConfig(total_steps=10)
    joc = j_adamw.AdamWConfig(total_steps=10)
    jstep = _jax_step(jcfg, joc)
    jp, jo = m["jparams"], j_adamw.adamw_init(m["jparams"], joc)
    p = jax.tree.map(torch.clone, m["params"])
    o = adamw_state_from_arrays(jax.tree.map(np.asarray, jo), device="cpu")
    step = make_train_step(cfg, oc)
    shape = ShapeCell("t", 24, 4, "train")
    for i in range(3):
        batch = synthetic_batch(cfg, shape, step=i)
        assert batch["tokens"].shape == (4, 24)
        jp, jo, jloss = jstep(jp, jo, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        p, o, loss = step(p, o, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want, first = flat(p), flat(jp), flat(m["params"])
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
        assert _rel_l2(got[key] - first[key], want[key] - first[key]) \
            < 1e-3, key
    assert int(o["step"]) == int(jo["step"]) == 3


def check_train_step_kernel_calls(m, plain_kernels, monkeypatch):
    """One remat train step through the kernel route (SSDScanFn and the
    norms' route counted): rmsnorm 2(L + L_ffn + L_ssm) + 1 a step (the
    forward's, again in the recompute), ssd_scan's forward 2 L_ssm and
    its backward L_ssm times, and the updated parameters those of the
    plain route's step bit for bit."""
    cfg = dataclasses.replace(m["cfg"], remat=True)
    norms = []
    real = rms_ops.rmsnorm_ref
    monkeypatch.setattr(rms_ops, "rmsnorm_ref",
                        lambda *a, **k: norms.append(1) or real(*a, **k))
    oc = adamw.AdamWConfig(total_steps=10)
    batch = synthetic_batch(cfg, ShapeCell("t", 24, 2, "train"), step=0)
    out = {}
    for kernel in (None, False):
        norms.clear()
        for k in plain_kernels:
            plain_kernels[k] = 0
        p = jax.tree.map(torch.clone, m["params"])
        p, _, loss = make_train_step(cfg, oc, use_kernel=kernel)(
            p, adamw.adamw_init(p, oc), batch)
        out[kernel] = (loss, flat(p), len(norms), dict(plain_kernels))
    L = cfg.num_layers
    L_ssm = sum(cfg.layer_kind(i)[0] == "ssm" for i in range(L))
    n_ffn = sum(cfg.layer_kind(i)[1] != "none" for i in range(L))
    assert out[None][2] == 2 * (L + n_ffn + L_ssm) + 1
    assert out[None][3] == {"fwd": 2 * L_ssm, "bwd": L_ssm}
    assert out[False][3] == {"fwd": 0, "bwd": 0}
    assert out[None][0] == out[False][0]
    for key, a in out[False][1].items():
        np.testing.assert_array_equal(out[None][1][key], a, err_msg=key)
    return L, out[None][2]


# ---------------------------------------------------------------------------
# mamba2-780m
# ---------------------------------------------------------------------------
def test_mamba2_loss_and_every_gradient_leaf_match_jax():
    check_loss_and_gradients(build("mamba2"))


def test_mamba2_remat_on_and_off_are_bitwise():
    check_remat_bitwise(build("mamba2"))


def test_mamba2_three_train_steps_match_jax():
    check_three_train_steps(build("mamba2"))


def test_mamba2_train_step_kernel_calls(plain_kernels, monkeypatch):
    """4L + 1 norms a step (ln1 and the gated norm, twice under remat, and
    ln_f), as chip_smoke's phase 8d holds the card's."""
    L, norms = check_train_step_kernel_calls(build("mamba2"), plain_kernels,
                                             monkeypatch)
    assert norms == 4 * L + 1


def test_synthetic_batches_for_the_ssm_and_hybrid_families():
    """The data pipeline's batches for both families: the train_4k shape,
    tokens in the vocabulary, labels the tokens themselves (the loss
    shifts them), one batch per step."""
    for arch in ("mamba2-780m", "jamba-v0.1-52b"):
        cfg = get_config(arch)
        shape = ShapeCell("train_4k", 4096, 2, "train")
        a, b = (synthetic_batch(cfg, shape, step=i) for i in (0, 1))
        assert a["tokens"].shape == a["labels"].shape == (2, 4096)
        assert 0 <= a["tokens"].min() and a["tokens"].max() < cfg.vocab_size
        assert np.array_equal(a["tokens"], a["labels"])
        assert not np.array_equal(a["tokens"], b["tokens"])
