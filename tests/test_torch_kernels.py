"""The port's kernel modules against the JAX package's on the CPU.

On the CPU the port's wrappers take their kernels' plain PyTorch versions;
these are held against the JAX kernels (Pallas in interpret mode) and
their oracles on the same numpy inputs. The CUDA kernels themselves are
held against the plain versions on the card: by `chip_smoke.py` and by
`tests/test_torch_cuda.py`.

Tolerances: dr_features forward 2e-4 (rtol and atol; sums of ~50 terms
in another order), its gradient 1e-4 (as the JAX package's own test),
al_step 1e-5 (as `tests/test_al_step.py`), on hinge-free (RTS-only) or
hinge-stable inputs, where the two formulations cannot flip an indicator;
rmsnorm and flash attention 1e-5 in float32 (sums in another order) and,
in bfloat16, rmsnorm rtol 2^-7 (one bf16 ulp of the output) and flash
attention 2e-2 (as `tests/test_kernels.py`); ssd_scan 1e-5 (as
`tests/test_kernels.py`; the same float32 products and sums in the same
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as JEngineConfig
from repro.kernels.al_step import ops as jops
from repro.kernels.al_step.kernel import al_step_pallas
from repro.kernels.al_step.ref import al_step_ref as j_al_step_ref
from repro.kernels.dr_features.ops import dr_features as j_dr_features
from repro.kernels.dr_features.ref import dr_features_ref as j_dr_ref
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ops import \
    flash_attention as j_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.rmsnorm.ops import rmsnorm as j_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_rmsnorm_ref
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ssd_scan_ref
from repro.models.attention import flash_attention_jnp
from repro_torch.core.engine import EngineConfig
from repro_torch.kernels import build
from repro_torch.kernels.al_step import ops as tops
from repro_torch.kernels.al_step.kernel import al_step_cuda
from repro_torch.kernels.al_step.ref import al_step_ref
from repro_torch.kernels.dr_features.kernel import dr_features_cuda
from repro_torch.kernels.dr_features.ops import dr_features
from repro_torch.kernels.dr_features.ref import dr_features_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

T = 48


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# dr_features
# ---------------------------------------------------------------------------
def _feature_rows(W, seed, hinge_rows=True, T_=T):
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 1.0, (W, T_)).astype(np.float32)
    d[np.abs(d) < 1e-3] += 0.01              # keep off measure-zero ties
    u = (np.abs(rng.normal(2.0, 0.3, d.shape)) + 0.5).astype(np.float32)
    j = (np.abs(rng.normal(1.0, 0.2, d.shape)) + 0.1).astype(np.float32)
    if hinge_rows:
        # Running sums cross zero mid-horizon, both ways, never on a tie.
        up_down = np.r_[np.full(T_ // 2, 0.7), np.full(T_ - T_ // 2, -0.9)]
        d[0], d[1] = up_down, -up_down
        u[:2], j[:2] = 2.0, 1.5
    return d, u, j


@pytest.mark.parametrize("W", [6, 130])
def test_dr_features_plain_matches_jax(W):
    d, u, j = _feature_rows(W, seed=W)
    ours = dr_features(_t(d), _t(u), _t(j))
    assert ours.shape == (W, 4)
    np.testing.assert_allclose(_np(dr_features_ref(_t(d), _t(u), _t(j))),
                               _np(ours), rtol=0, atol=0)
    for theirs in (j_dr_features(d, u, j, interpret=True),
                   j_dr_ref(d, u, j)):
        np.testing.assert_allclose(_np(ours), _np(theirs), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("hinge_rows", [False, True])
def test_dr_features_grad_matches_jax_vjp(hinge_rows):
    """The autograd.Function's backward (torch ops, strict `>`) against
    `jax.vjp` of the JAX package's custom-VJP `dr_features`."""
    d, u, j = _feature_rows(6, seed=7, hinge_rows=hinge_rows)
    ct = np.random.default_rng(1).normal(size=(6, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda dd: j_dr_features(dd, u, j, interpret=True),
                     jnp.asarray(d))
    (want,) = vjp(jnp.asarray(ct))
    dt = _t(d).requires_grad_(True)
    (got,) = torch.autograd.grad(dr_features(dt, _t(u), _t(j)), dt, _t(ct))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("T_", [1, 33, 64])
def test_dr_features_plain_matches_jax_other_horizons(T_):
    """Horizons that fill the CUDA kernel's lanes unevenly (one hour; runs
    of 5 and a short lane) or fully at 8 hours a lane."""
    d, u, j = _feature_rows(9, seed=T_, T_=T_)
    ours = dr_features(_t(d), _t(u), _t(j))
    assert ours.shape == (9, 4)
    for theirs in (j_dr_features(d, u, j, interpret=True),
                   j_dr_ref(d, u, j)):
        np.testing.assert_allclose(_np(ours), _np(theirs), rtol=2e-4,
                                   atol=2e-4)


def test_dr_features_cuda_wrapper_refuses_cpu_tensors():
    d, u, j = (_t(a) for a in _feature_rows(4, seed=0))
    before = dr_features_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        dr_features_cuda(d, u, j)
    assert dr_features_cuda.launches == before


# ---------------------------------------------------------------------------
# al_step
# ---------------------------------------------------------------------------
def _fleet_rows(W, seed, rts_only, T_=T):
    """Per-row penalty parameters of a random fleet: half batch rows
    unless `rts_only` (hinge-free: the smooth cubic penalty only)."""
    rng = np.random.default_rng(seed)
    usage = np.abs(rng.normal(2.0, 0.5, (W, T_))) + 0.5
    E = usage.max(1) * 1.3
    isb = np.zeros(W, bool) if rts_only else np.arange(W) % 2 == 1
    rts = np.where(isb[:, None], 0.0, [[6.3, -13.0, 51.6]])
    if rts_only:
        rts[1::2] = [2e-4, 1.5e-3, 0.04]
    betas = np.where(isb[:, None], [[0.3, 0.05, 0.02]], 0.0)
    x2k = (np.arange(W) % 4 == 1).astype(float)
    jobs = np.where(isb[:, None], np.abs(rng.normal(3.0, 1.0, (W, T_))), 1.0)
    k = rng.uniform(0.01, 0.05, W)
    hi = np.minimum(0.5 * E[:, None], usage)
    lo = np.where(isb[:, None], -(E[:, None] - usage), 0.0)
    return dict(usage=usage, jobs=jobs, lo=lo, hi=hi, rts=rts, betas=betas,
                k=k, x2k=x2k, isb=isb)


def _al_inputs(W, mode, seed, rts_only=True, stable=False, T_=T):
    """(x, m, v, usage, jobs, lo, hi, rowp, cvec, scal) as numpy f32, with
    `rowp` packed by the JAX package's `pack_rows`."""
    f = _fleet_rows(W, seed, rts_only, T_)
    rng = np.random.default_rng(seed + 100)
    if stable:
        x = np.clip(0.25 * f["usage"] + 0.01, f["lo"], f["hi"])
    else:
        x = np.clip(rng.normal(0.0, 0.3, f["lo"].shape), f["lo"], f["hi"])
    m = rng.normal(0.0, 0.01, x.shape)
    v = np.abs(rng.normal(0.0, 1e-4, x.shape))
    refs = np.abs(rng.normal(1.0, 0.2, W)) if mode == "cr2" else None
    row10 = np.asarray(jops.pack_rows(
        jnp.asarray(f["rts"]), jnp.asarray(f["betas"]), jnp.asarray(f["k"]),
        jnp.asarray(f["x2k"]), jnp.asarray(f["isb"]),
        refs=None if refs is None else jnp.asarray(refs)))
    lam = rng.normal(0.0, 0.5, (W, 1)) if mode == "cr2" else np.zeros((W, 1))
    rowp = np.concatenate([row10, lam, np.ones((W, 1))], axis=1)
    cvec = rng.normal(-0.5, 0.2, (1, T_))
    scal = np.array([[1.45, 10.0, 0.8, 0.02, 3.0, 0, 0, 0]])
    return [np.asarray(a, np.float32) for a in
            (x, m, v, f["usage"], f["jobs"], f["lo"], f["hi"], rowp, cvec,
             scal)]


def _compare(args, mode, k_steps, tol=1e-5, bf16=False, day_hours=24):
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    if bf16:
        jargs[1], jargs[2] = (a.astype(jnp.bfloat16) for a in jargs[1:3])
        targs[1], targs[2] = targs[1].bfloat16(), targs[2].bfloat16()
    theirs = j_al_step_ref(*jargs, mode=mode, k_steps=k_steps,
                           day_hours=day_hours)
    ours = tops.al_step(*targs, mode=mode, k_steps=k_steps,
                        day_hours=day_hours)
    for o, r, name in zip(ours, theirs, "xmv"):
        np.testing.assert_allclose(_np(o), np.asarray(r, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)
    return ours


def test_pack_rows_matches_jax():
    f = _fleet_rows(9, seed=3, rts_only=False)
    refs = np.linspace(0.5, 1.5, 9)
    want = jops.pack_rows(*(jnp.asarray(f[n]) for n in
                            ("rts", "betas", "k", "x2k", "isb")),
                          refs=jnp.asarray(refs))
    got = tops.pack_rows(*(torch.as_tensor(f[n]) for n in
                           ("rts", "betas", "k", "x2k", "isb")),
                         refs=torch.as_tensor(refs))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("mode", ["cr1", "cr2"])
@pytest.mark.parametrize("k_steps", [1, 4, 7])
def test_al_step_rts_matches_jax(mode, k_steps):
    """Hinge-free multi-step parity on the iterate and both moments."""
    _compare(_al_inputs(12, mode, seed=k_steps), mode, k_steps)


@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_al_step_batch_rows_single_step(mode):
    """Mixed RTS + batch rows, one step from a hinge-stable point."""
    _compare(_al_inputs(12, mode, seed=5, rts_only=False, stable=True), mode,
             1)


@pytest.mark.parametrize("mode", ["cr1", "cr2"])
@pytest.mark.parametrize("T_,day_hours", [(30, 10), (64, 24), (33, 24)])
def test_al_step_batch_rows_other_horizons(T_, day_hours, mode):
    """Mixed rows at horizons whose hours fill the CUDA kernel's lanes
    unevenly or straddle days, one step from a hinge-stable point after
    which no bound is active (where the JAX oracle's 3 rounds of day-mean
    removal equal the exact projection): the plain version against the
    oracle and the Pallas kernel in interpret mode."""
    args = _al_inputs(12, mode, seed=T_, rts_only=False, stable=True, T_=T_)
    ours = _compare(args, mode, 1, day_hours=day_hours)
    x, lo, hi, isb = _np(ours[0]), args[5], args[6], args[7][:, 8] > 0.5
    assert ((x > lo) & (x < hi))[isb].all()
    theirs = al_step_pallas(*(jnp.asarray(a) for a in args), mode=mode,
                            k_steps=1, day_hours=day_hours, interpret=True)
    for o, r, name in zip(ours, theirs, "xmv"):
        np.testing.assert_allclose(_np(o), np.asarray(r, np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("W", [5, 130])
def test_al_step_widths(W):
    out = _compare(_al_inputs(W, "cr1", seed=0), "cr1", 2)
    assert out[0].shape == (W, T)


def test_al_step_bf16_moments():
    """bf16 moments: both up-cast on load and round once on store."""
    out = _compare(_al_inputs(8, "cr1", seed=3), "cr1", 4, bf16=True)
    assert out[1].dtype == out[2].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_al_step_per_row_cvec(mode):
    args = _al_inputs(8, mode, seed=9)
    args[8] = np.random.default_rng(2).normal(
        -0.5, 0.2, (8, T)).astype(np.float32)
    _compare(args, mode, 3)


def test_al_step_tie_convention_at_the_cold_start():
    """At x = 0 every hinge sits on an exact tie. The port's al_step takes
    autodiff's one half there, so its first step equals the generic
    engine's: projected Adam on the autodiff gradient of the same
    Lagrangian (CR1: coef0·Σpen + cvec·x)."""
    args = [_t(a) for a in _al_inputs(10, "cr1", seed=4, rts_only=False)]
    x, m, v, u, j, lo, hi, rowp, cvec, scal = args
    x, m, v = torch.zeros_like(x), torch.zeros_like(m), torch.zeros_like(v)
    scal[0, 4] = 0.0
    ours = al_step_ref(x, m, v, u, j, lo, hi, rowp, cvec, scal, mode="cr1",
                       k_steps=1)
    from repro_torch.core.fleet_solver import (FleetProblem, _projection,
                                               fleet_penalties)
    isb = rowp[:, 8] > 0.5
    p = FleetProblem(usage=u, entitlement=torch.ones(10), k=rowp[:, 6],
                     rts_coeffs=rowp[:, 0:3], betas=rowp[:, 3:6],
                     x2_kind=rowp[:, 7], jobs=j, is_batch=isb,
                     mci=torch.zeros(T))
    xg = x.clone().requires_grad_(True)
    L = scal[0, 0] * fleet_penalties(p, xg, False).sum() + (cvec * xg).sum()
    (g,) = torch.autograd.grad(L, xg)
    assert (g != cvec).any()                 # the ties carry gradient
    step = scal[0, 3] * g / (g.abs() + 1e-8)  # Adam's first step
    want = _projection(p, lo, hi)(x - step)
    np.testing.assert_allclose(_np(ours[0]), _np(want), rtol=1e-5, atol=1e-5)


def test_al_step_rejects_bad_mode():
    args = [_t(a) for a in _al_inputs(4, "cr1", seed=0)]
    with pytest.raises(ValueError, match="cr1|cr2"):
        al_step_ref(*args, mode="cr3", k_steps=1)
    with pytest.raises(ValueError, match="cr1|cr2"):
        al_step_cuda(*args, mode="cr3", k_steps=1)


def test_al_step_cuda_wrapper_refuses_cpu_tensors_and_long_rows():
    args = [_t(a) for a in _al_inputs(4, "cr1", seed=0)]
    before = al_step_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        al_step_cuda(*args, mode="cr1", k_steps=1)
    with pytest.raises(ValueError, match="T <= 64"):
        build.check_hours(65)
    assert al_step_cuda.launches == before


@pytest.mark.parametrize("steps,k_steps", [(13, 5), (8, 8), (6, 16)])
def test_fused_inner_chunking_matches_jax(steps, k_steps):
    """`make_fused_inner` runs full chunks, then the remainder, carrying
    t0: uneven splits, exact fits, and k_steps > inner_steps."""
    f = _fleet_rows(8, seed=6, rts_only=True)
    mci = np.linspace(250.0, 420.0, T)
    cvec = (-0.01 * mci[None, :]).astype(np.float32)
    jrow = jops.pack_rows(*(jnp.asarray(f[n]) for n in
                            ("rts", "betas", "k", "x2k", "isb")))
    jfi = jops.make_fused_inner(
        *(jnp.asarray(f[n], jnp.float32) for n in ("usage", "jobs", "lo",
                                                   "hi")),
        jrow, jnp.asarray(cvec), mode="cr1",
        cfg=JEngineConfig(inner_steps=steps, outer_steps=1), step_scale=1.0,
        coef0=1.45, k_steps=k_steps, use_ref=True)
    tfi = tops.make_fused_inner(
        *(_t(f[n]) for n in ("usage", "jobs", "lo", "hi")),
        tops.pack_rows(*(torch.as_tensor(f[n]) for n in
                         ("rts", "betas", "k", "x2k", "isb"))),
        _t(cvec), mode="cr1", cfg=EngineConfig(inner_steps=steps),
        step_scale=1.0, coef0=1.45, k_steps=k_steps)
    zl = np.zeros(0, np.float32)
    want = jfi(jnp.zeros((8, T)), jnp.asarray(zl), jnp.asarray(zl),
               jnp.asarray(10.0))
    got = tfi(torch.zeros(8, T), _t(zl), _t(zl), torch.tensor(10.0))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_fused_inner_orders_rows_by_kind_and_back(mode):
    """`make_fused_inner` steps the rows ordered by kind and gives x back
    in the caller's order: the plain steps on the interleaved rows as
    given, chunked and carried as the callback does, give the same x."""
    W, steps, k_steps, scale, lr = 10, 11, 4, 1.25, 0.05
    x, _, _, usage, jobs, lo, hi, rowp, cvec, _ = (
        _t(a) for a in _al_inputs(W, mode, seed=17, rts_only=False,
                                  stable=True))
    assert bool((rowp[0::2, 8] == 0).all() and (rowp[1::2, 8] == 1).all())
    fi = tops.make_fused_inner(
        usage, jobs, lo, hi, rowp[:, :10], cvec, mode=mode,
        cfg=EngineConfig(inner_steps=steps, lr=lr), step_scale=1.0,
        coef0=1.45, scale=scale if mode == "cr2" else None, k_steps=k_steps)
    got = fi(x, rowp[:, 10], torch.zeros(0), torch.tensor(10.0))
    m = v = torch.zeros_like(x)
    for c, n in enumerate((4, 4, 3)):
        scal = torch.tensor([[1.45, 10.0, 1.0 / scale if mode == "cr2"
                              else 0.0, lr, c * k_steps, 0, 0, 0]])
        x, m, v = al_step_ref(x, m, v, usage, jobs, lo, hi, rowp, cvec, scal,
                              mode=mode, k_steps=n)
    np.testing.assert_allclose(_np(got), _np(x), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------
def _bf16_to_np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


def _to_jax(a, bf16):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)


def _to_torch(a, bf16):
    t = torch.as_tensor(np.asarray(a, np.float32))
    return t.bfloat16() if bf16 else t


@pytest.mark.parametrize("shape,bf16", [
    ((4, 37, 128), False),      # ragged rows
    ((3, 2560), False),         # stablelm-3b's width
    ((2, 7, 2560), True),
    ((5, 100), True),           # a width that is no whole 16-byte vector
    ((1, 1, 128), False),
    ((2, 8192), True),          # qwen1.5-110b's width: rows over two warps
    ((3, 777), False),          # an odd width
])
def test_rmsnorm_plain_matches_jax(shape, bf16):
    """Against the JAX oracle and the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    x = rng.normal(0.0, 1.5, shape)
    s = rng.normal(1.0, 0.1, shape[-1])
    got = rms_ops.rmsnorm(_to_torch(x, bf16), torch.as_tensor(
        s, dtype=torch.float32))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert torch.equal(got, rmsnorm_ref(_to_torch(x, bf16), torch.as_tensor(
        s, dtype=torch.float32)))
    jx, js = _to_jax(x, bf16), jnp.asarray(s, jnp.float32)
    tol = dict(rtol=2.0 ** -7, atol=1e-6) if bf16 else dict(rtol=1e-5,
                                                            atol=1e-5)
    for want in (j_rmsnorm_ref(jx, js), j_rmsnorm(jx, js)):
        np.testing.assert_allclose(_bf16_to_np(got), _bf16_to_np(want),
                                   **tol)


def test_rmsnorm_cuda_wrapper_refuses_cpu_tensors():
    x, s = torch.ones(4, 8), torch.ones(8)
    before = rmsnorm_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(x, s)
    with pytest.raises(ValueError, match="CUDA"):
        rms_ops.rmsnorm(x, s, use_kernel=True)
    assert rmsnorm_cuda.launches == before


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FA_CASES = [
    # (B, Sq, Skv, H, KV, Dh, Dv, causal, bf16, Pallas block)
    (2, 120, 120, 4, 4, 80, 80, True, False, 64),    # stablelm: Dh 80, tail
    (1, 120, 120, 4, 2, 80, 80, True, True, 64),     # GQA, bf16
    (2, 64, 100, 4, 1, 32, 32, False, False, 32),    # MQA cross-attention
    (1, 70, 70, 4, 2, 64, 32, True, False, 32),      # Dv != Dh
    (1, 320, 320, 2, 2, 80, 80, True, False, 64),    # 5 kv blocks, causal
]


def _fa_inputs(case, seed):
    B, Sq, Skv, H, KV, Dh, Dv, _, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, Dh)), rng.normal(size=(B, Skv, KV, Dh)),
            rng.normal(size=(B, Skv, KV, Dv)))


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_plain_matches_jax(case):
    """Against the JAX oracle and the Pallas kernel (interpret mode)."""
    causal, bf16, blk = case[7], case[8], case[9]
    q, k, v = _fa_inputs(case, seed=sum(case[:7]))
    got = fa_ops.flash_attention(*(_to_torch(a, bf16) for a in (q, k, v)),
                                 causal=causal)
    assert got.shape == case[:2] + (case[3], case[6])
    jq, jk, jv = (_to_jax(a, bf16) for a in (q, k, v))
    tol = 2e-2 if bf16 else 1e-5
    for want in (j_attention_ref(jq, jk, jv, causal=causal),
                 j_flash_attention(jq, jk, jv, causal=causal, block_q=blk,
                                   block_k=blk)):
        np.testing.assert_allclose(_bf16_to_np(got), _bf16_to_np(want),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("q_offset", [0, 7, 50])
def test_flash_attention_q_offset_matches_jax(q_offset):
    """A query block at an offset against a longer key sequence: the JAX
    model's chunked path and the Pallas kernel (interpret mode), which
    take `q_offset` where the JAX oracle does not."""
    case = (1, 24, 80, 4, 2, 80, 80, True, False, 32)
    q, k, v = _fa_inputs(case, seed=q_offset)
    got = fa_ops.flash_attention(*(_to_torch(a, False) for a in (q, k, v)),
                                 causal=True, q_offset=q_offset)
    jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in (q, k, v))
    chunked = flash_attention_jnp(jq, jk, jv, causal=True, chunk=32,
                                  q_offset=q_offset)
    pallas = flash_attention_pallas(
        *(a.transpose(0, 2, 1, 3) for a in (jq, jk, jv)), causal=True,
        block_q=32, block_k=32, q_offset=q_offset, interpret=True)
    for want in (chunked, pallas.transpose(0, 2, 1, 3)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_flash_attention_cuda_wrapper_refuses_cpu_tensors():
    q = torch.ones(1, 8, 4, 16)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention(q, q, q, use_kernel=True)
    assert flash_attention_cuda.launches == before


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------
def _scan_inputs(dims, seed):
    B, NC, H, P, N = dims
    rng = np.random.default_rng(seed)
    return (rng.normal(size=dims).astype(np.float32),
            (0.5 * np.abs(rng.normal(size=(B, NC, H)))).astype(np.float32))


@pytest.mark.parametrize("dims", [
    (2, 6, 4, 16, 32), (1, 12, 2, 8, 16), (3, 3, 8, 32, 64),  # test_kernels
    (2, 1, 3, 16, 32),                                        # NC = 1
    (2, 5, 3, 5, 7),                                          # odd (P, N)
])
def test_ssd_scan_plain_matches_jax(dims):
    """Against the JAX oracle and the Pallas kernel (interpret mode)."""
    states, dec = _scan_inputs(dims, seed=sum(dims))
    got = ssd_ops.ssd_scan(_t(states), _t(dec))
    assert got[0].shape == dims and got[1].shape == dims[:1] + dims[2:]
    assert all(torch.equal(a, b) for a, b in
               zip(got, ssd_scan_ref(_t(states), _t(dec))))
    for want in (j_ssd_scan_ref(jnp.asarray(states), jnp.asarray(dec)),
                 j_ssd_scan(jnp.asarray(states), jnp.asarray(dec),
                            interpret=True)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_ssd_scan_plain_initial_state_matches_jax():
    """An initial state, which the JAX oracle takes (the Pallas kernel
    starts from zeros); states in bfloat16 are taken in float32."""
    states, dec = _scan_inputs((2, 4, 3, 8, 16), seed=1)
    h0 = np.random.default_rng(2).normal(size=(2, 3, 8, 16)).astype(
        np.float32)
    got = ssd_ops.ssd_scan(_t(states), _t(dec), _t(h0))
    want = j_ssd_scan_ref(jnp.asarray(states), jnp.asarray(dec),
                          jnp.asarray(h0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    bf = torch.as_tensor(states).bfloat16()
    got = ssd_ops.ssd_scan(bf, _t(dec))
    want = j_ssd_scan_ref(jnp.asarray(states, jnp.bfloat16), jnp.asarray(dec))
    assert got[0].dtype == got[1].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_ssd_scan_cuda_wrapper_refuses_cpu_tensors():
    states, dec = (_t(a) for a in _scan_inputs((1, 2, 2, 4, 4), seed=0))
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(states, dec)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_ops.ssd_scan(states, dec, use_kernel=True)
    assert ssd_scan_cuda.launches == before
