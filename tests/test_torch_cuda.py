"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine with the card alone:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances and inputs as in `chip_smoke.py`: dr_features 2e-4 on random
rows; al_step 1e-5 on the rows of the chip_smoke fleet, hinge-free
(RTS-only) or hinge-stable; rmsnorm one bf16 ulp of the output (rtol
2^-7) and 1e-5 in float32; flash attention 2e-2 in bfloat16 (as the JAX
package's kernel tests) and 1e-4 in float32; ssd_scan 1e-5 (as the JAX
package's kernel tests); the reduced stablelm's and mamba2's bfloat16
logits through the kernels within 0.05 of those through the plain
versions; the rolling-horizon day as a CUDA-graph replay
(`api.solve_day`) within 1e-6 NP of the same day run eagerly through the
same kernels (bitwise in practice), with its launches per replay counted
on the device by `torch.profiler`; multi-region solves through the
kernels within 0.05 pp of the generic engine, and the SLSQP reference
and the per-region sums repeat bit for bit; a NaN in usage or jobs at
the same positions through al_step and dr_features as through their
plain versions; training: the rmsnorm and flash-attention autograd
Functions' backwards within 1e-5 (f32) and 2e-2 (bf16, relative L2) of
autograd through the plain versions, their forwards bitwise the
buffer-free kernel calls, and one train step's loss of stablelm-3b at
full width (2 layers) through the kernels within 1e-3 of the plain path;
whisper-large-v3 at full width and 2 + 2 layers, and a reduced qwen3
with qk-norm, through the kernels within chip_smoke's serving bounds of
the plain versions, and the int8 KV cache's decode steps finite; a
reduced qwen3-moe and deepseek-v3 (MLA at its own widths, Dh 192 and Dv
128) within those bounds, and their decode steps against the forward; a
reduced jamba (hybrid) within those bounds and its launches, its decode
over the mixed cache against the forward in float32 (1e-4), and rmsnorm
and ssd_scan bit for bit their plain versions at jamba's shapes; the
ssd_scan backward kernel's dstates and dh0 bit for bit autograd's through
the plain version and its decay gradient within 1e-6 relative L2 at
chip_smoke's cases, `SSDScanFn` so through `ssd_chunked`, and mamba2-780m
at full width and 2 layers: loss within 1e-3 and each gradient leaf
within 0.05 relative L2 through the kernels of the plain path's, with the
launches a remat step makes; a fleet solve over a world-1 NCCL mesh
within 0.01 pp of the unsharded solve at the same launches, and a
sharded 24-tick day (its own graph, captured then replayed), CR2 sweep
and CR1 ensemble bitwise the unsharded calls at the same launches
(`-k sharded`).
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.al_step.kernel import al_step_cuda
from repro_torch.kernels.al_step.ref import al_step_ref
from repro_torch.kernels.dr_features.kernel import dr_features_cuda
from repro_torch.kernels.dr_features.ops import dr_features
from repro_torch.kernels.dr_features.ref import dr_features_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_bwd_cuda,
                                                 ssd_scan_cuda)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref

T = 48
pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _f32(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _feature_rows(W, seed, dev):
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 1.0, (W, T))
    u = np.abs(rng.normal(2.0, 0.3, (W, T))) + 0.5
    j = np.abs(rng.normal(1.0, 0.2, (W, T))) + 0.1
    up_down = np.r_[np.full(T // 2, 0.7), np.full(T // 2, -0.9)]
    d[:2] = np.stack([up_down, -up_down])[:W]
    return [_f32(a, dev) for a in (d, u, j)]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """chip_smoke.py's fleets: the paper fleet at its reduced calibration,
    cloned to W = 10,000 and to a W = 130 tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    from repro_torch.core.fleet_solver import synthetic_fleet
    from repro_torch.core.fleetcache import cached_paper_fleet
    fleet = cached_paper_fleet(num_samples=32, num_jobs=1000, device="cuda",
                               cache_dir=tmp_path_factory.mktemp("fleet"))
    out = {W: synthetic_fleet(W, hours=T, seed=s, templates=fleet)
           for W, s in ((10_000, 0), (130, 1))}
    out["templates"] = fleet
    return out


def _al_inputs(fleets, W, mode, seed, dev, **kw):
    """The kernel-check inputs of chip_smoke.py, on the card."""
    arrs = _load_chip_smoke().al_step_inputs(np, fleets[W], mode=mode,
                                             seed=seed, **kw)
    return [_f32(a, dev) for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("W", [1, 130, 10_000])
def test_dr_features_kernel_matches_plain(dev, W):
    d, u, j = _feature_rows(W, W, dev)
    before = dr_features_cuda.launches
    _close(dr_features(d, u, j), dr_features_ref(d, u, j), 2e-4)
    assert dr_features_cuda.launches == before + 1


def test_dr_features_kernel_rejects_long_rows(dev):
    d = torch.zeros((4, 65), device=dev)
    with pytest.raises(ValueError, match="T <= 64"):
        dr_features_cuda(d, d, d)


@pytest.mark.parametrize("T_", [1, 20, 24, 33, 64])
def test_dr_features_kernel_other_horizons(dev, T_):
    d, u, j = (a[:, :T_].contiguous() for a in _feature_rows(33, 3, dev))
    _close(dr_features_cuda(d, u, j), dr_features_ref(d, u, j), 2e-4)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k_steps", [1, 8])
@pytest.mark.parametrize("mode", ["cr1", "cr2"])
@pytest.mark.parametrize("W", [130, 10_000])
def test_al_step_kernel_matches_plain_rts(dev, fleets, W, mode, k_steps,
                                         bf16):
    args = _al_inputs(fleets, W, mode, seed=W + k_steps, dev=dev)
    if bf16:
        args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    kw = dict(mode=mode, k_steps=k_steps)
    got, want = al_step_cuda(*args, **kw), al_step_ref(*args, **kw)
    _close(got[0], want[0], 1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(),
                                   rtol=2.0 ** -7 if bf16 else 1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_al_step_kernel_matches_plain_mixed(dev, fleets, mode, cold):
    """One step from a hinge-stable point, or from the cold start x = 0
    where every hinge ties exactly."""
    args = _al_inputs(fleets, 10_000, mode, seed=3, dev=dev, rts_only=False,
                      stable=True)
    if cold:
        args[0], args[1], args[2] = (torch.zeros_like(a) for a in args[:3])
        args[9][0, 4] = 0.0
    kw = dict(mode=mode, k_steps=1)
    for g, w in zip(al_step_cuda(*args, **kw), al_step_ref(*args, **kw)):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_al_step_kernel_keeps_nan_as_its_plain_version(dev, fleets, mode):
    """A NaN in the carbon term reaches x where the plain version
    (torch.clamp, the day projection) puts it: hour 7 of RTS rows, the
    first day of batch rows; the sanitizer's check on x must see what the
    kernel computed. On the next step both keep a NaN on every row."""
    args = _al_inputs(fleets, 130, mode, seed=5, dev=dev, rts_only=False,
                      stable=True)
    args[8] = args[8].clone()
    args[8][..., 7] = float("nan")
    isb = args[7][:, 8] > 0.5
    got, want = (f(*args, mode=mode, k_steps=1)[0]
                 for f in (al_step_cuda, al_step_ref))
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert nan[~isb, 7].all() and nan[isb, :24].all()
    _close(torch.where(nan, 0.0, got), torch.where(nan, 0.0, want), 1e-5)
    for f in (al_step_cuda, al_step_ref):
        assert torch.isnan(f(*args, mode=mode, k_steps=2)[0]).any(1).all()


@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_al_step_kernel_ill_conditioned_tiny_v(dev, fleets, mode):
    """v drawn below m², as the JAX package's kernel tests draw it: m/√v
    magnifies ulp-level gradient differences, so 1e-4 (one element of
    480,000 once came 1.18e-5 apart on such inputs)."""
    args = _al_inputs(fleets, 10_000, mode, seed=3, dev=dev, rts_only=False,
                      stable=True, tiny_v=True)
    kw = dict(mode=mode, k_steps=1)
    for g, w in zip(al_step_cuda(*args, **kw), al_step_ref(*args, **kw)):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_al_step_kernel_projection_at_bounds(dev, fleets, mode):
    """Batch days with many hours at a bound: the kernel's day projection
    against its plain version, and the days it leaves sum to zero."""
    args = _al_inputs(fleets, 10_000, mode, seed=4, dev=dev, rts_only=False,
                      at_bounds=True)
    got = al_step_cuda(*args, mode=mode, k_steps=8)
    for g, w in zip(got, al_step_ref(*args, mode=mode, k_steps=8)):
        _close(g, w, 1e-5)
    isb = args[7][:, 8] > 0.5
    x, lo, hi = got[0], args[5], args[6]
    assert ((x == lo) | (x == hi))[isb].float().mean() > 0.05
    assert float(x[isb].reshape(-1, 2, 24).sum(-1).abs().max()) < 1e-3


def test_al_step_kernel_per_row_cvec_and_other_horizons(dev, fleets):
    args = _al_inputs(fleets, 130, "cr2", seed=5, dev=dev)
    args[8] = torch.randn((130, T), device=dev,
                          generator=torch.Generator(dev).manual_seed(0))
    for g, w in zip(al_step_cuda(*args, mode="cr2", k_steps=4),
                    al_step_ref(*args, mode="cr2", k_steps=4)):
        _close(g, w, 1e-5)
    for T_, dh in ((20, 24), (24, 24), (30, 10), (48, 16)):
        a = [t[:, :T_].contiguous() if t.dim() == 2 and t.shape[1] == T
             else t for t in _al_inputs(fleets, 130, "cr1", seed=T_,
                                        dev=dev, rts_only=False,
                                        stable=True)]
        kw = dict(mode="cr1", k_steps=1, day_hours=dh)
        for g, w in zip(al_step_cuda(*a, **kw), al_step_ref(*a, **kw)):
            _close(g, w, 1e-5)


@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_al_step_kernel_horizon_shorter_than_a_day(dev, fleets, mode):
    """T = 12 with day_hours = 24: kernel and plain version both project
    the horizon as one 12-hour day, whose batch sums close."""
    a = [t[:, :12].contiguous() if t.dim() == 2 and t.shape[1] == T else t
         for t in _al_inputs(fleets, 130, mode, seed=12, dev=dev,
                             rts_only=False, at_bounds=True)]
    kw = dict(mode=mode, k_steps=8, day_hours=24)
    got = al_step_cuda(*a, **kw)
    for g, w in zip(got, al_step_ref(*a, **kw)):
        _close(g, w, 1e-5)
    isb = a[7][:, 8] > 0.5
    assert float(got[0][isb].sum(-1).abs().max()) < 1e-3


def _rows(args, idx):
    """The kernel inputs of rows `idx` (a (1, T) cvec and scal as they
    are)."""
    W = args[0].shape[0]
    idx = torch.as_tensor(idx, device=args[0].device)
    return [a[idx].contiguous() if a.shape[0] == W else a for a in args]


def _hours(args, T_):
    """The kernel inputs at horizon T_: the fleet's hours, repeated from
    hour 0 past T = 48."""
    hours = torch.arange(T_, device=args[0].device) % T
    return [a[:, hours].contiguous() if a.shape[1] == T else a for a in args]


def _check_layout_cases(args_of, day_hours=24):
    """One step from hinge-stable rows, and 8 steps from rows spread over
    their boxes (the day projection fixes hours), against the plain
    version at 1e-5; the batch days of the second case sum to zero."""
    for mode, k, kind in (("cr2", 1, dict(stable=True)),
                          ("cr1", 8, dict(at_bounds=True))):
        args = args_of(mode, kind)
        kw = dict(mode=mode, k_steps=k, day_hours=day_hours)
        before = al_step_cuda.launches
        got = al_step_cuda(*args, **kw)
        assert al_step_cuda.launches == before + 1
        for g, w in zip(got, al_step_ref(*args, **kw)):
            _close(g, w, 1e-5)
    isb = args[7][:, 8] > 0.5
    dh = min(day_hours, args[0].shape[1])
    span = args[0].shape[1] // dh * dh
    if isb.any():
        days = got[0][isb][:, :span].reshape(int(isb.sum()), -1, dh).sum(-1)
        assert float(days.abs().max()) < 1e-3


@pytest.mark.parametrize("W", [1, 3, 5, 10_001])
def test_al_step_kernel_partial_row_groups(dev, fleets, W):
    """Rows that leave the last warp's and the last block's row groups
    partly empty."""
    def args_of(mode, kind):
        src = 130 if W < 130 else 10_000
        args = _al_inputs(fleets, src, mode, seed=W, dev=dev, rts_only=False,
                          **kind)
        return _rows(args, list(range(min(W, src))) + [0] * max(0, W - src))
    _check_layout_cases(args_of)


@pytest.mark.parametrize("T_", [1, 7, 33, 64])
def test_al_step_kernel_uneven_runs(dev, fleets, T_):
    """Horizons whose hours fill the lanes unevenly (T = 7: one hour a
    lane and an empty lane; 33: runs of 5 and a short and an empty lane)
    or fully at 8 hours a lane (64), with 24-hour days."""
    _check_layout_cases(lambda mode, kind: _hours(_al_inputs(
        fleets, 130, mode, seed=T_, dev=dev, rts_only=False, **kind), T_))


@pytest.mark.parametrize("layout", ["alternating", "batch_only", "by_kind",
                                    "two_batch_one_rts"])
def test_al_step_kernel_row_kinds_in_a_warp(dev, fleets, layout):
    """Rows that alternate RTS and batch, batch rows only, rows ordered by
    kind (windows of one kind), and two batch rows to each RTS row
    (windows with an odd count of batch rows)."""
    def args_of(mode, kind):
        args = _al_inputs(fleets, 10_000, mode, seed=7, dev=dev,
                          rts_only=False, **kind)
        isb = (args[7][:, 8] > 0.5).cpu().numpy()
        rts, bat = np.flatnonzero(~isb)[:70], np.flatnonzero(isb)[:141]
        idx = {"alternating": np.stack([rts, bat[:70]], 1).ravel(),
               "batch_only": bat,
               "by_kind": np.r_[bat[:70], rts],
               "two_batch_one_rts": np.stack(
                   [bat[0:140:2], bat[1:140:2], rts], 1).ravel()}[layout]
        return _rows(args, idx)
    _check_layout_cases(args_of)


@pytest.mark.parametrize("day_hours", [1, 5])
def test_al_step_kernel_short_days(dev, fleets, day_hours):
    """Many days a row at T = 48: one-hour days, and five-hour days whose
    hours straddle the lanes' runs of 6 (with 3 hours past the last whole
    day)."""
    _check_layout_cases(lambda mode, kind: _al_inputs(
        fleets, 130, mode, seed=day_hours, dev=dev, rts_only=False, **kind),
        day_hours=day_hours)


# ---------------------------------------------------------------------------
# rmsnorm and flash attention (the serving path)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,d,bf16", [(960, 2560, True), (8, 2560, True),
                                      (5, 100, True), (33, 128, False),
                                      (3, 8192, False), (3072, 1536, True),
                                      (3072, 3072, True), (32_768, 128, True),
                                      (12_000, 1280, True), (512, 8192, True),
                                      (2048, 8192, True), (512, 4096, True),
                                      (2048, 4096, True), (8192, 4096, True),
                                      (8192, 8192, True), (8, 4096, True)])
def test_rmsnorm_kernel_matches_plain(dev, N, d, bf16):
    gen = torch.Generator(device=dev).manual_seed(N + d)
    x = 1.5 * torch.randn((N, d), generator=gen, device=dev)
    x = x.bfloat16() if bf16 else x
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    before = rmsnorm_cuda.launches
    got = rmsnorm_cuda(x, scale)
    assert rmsnorm_cuda.launches == before + 1
    assert got.dtype == x.dtype
    np.testing.assert_allclose(
        got.float().cpu().numpy(), rmsnorm_ref(x, scale).float().cpu().numpy(),
        rtol=2.0 ** -7 if bf16 else 1e-5, atol=1e-6 if bf16 else 1e-5)


@pytest.mark.parametrize("N,d,bf16", [
    (1001, 4096, True),     # one warp's 16 vectors a lane; N % 8 = 1
    (1001, 4104, True),     # one vector more: two warps a row
    (37, 8192, True),       # qwen1.5-110b's width
    (5, 8192, False),
    (1001, 2040, False),    # float32 at 16 vectors a lane, N % 8 = 1
    (9, 3000, True),        # decode-sized, a width of no power of two
    (3, 777, False),        # an odd width: rows and scale one at a time
])
def test_rmsnorm_kernel_both_sides_of_the_warp_limit(dev, N, d, bf16):
    """Rows in one warp's registers and rows split over a group of warps,
    with the last block of rows partly empty."""
    gen = torch.Generator(device=dev).manual_seed(N * d)
    x = 1.5 * torch.randn((N, d), generator=gen, device=dev)
    x = x.bfloat16() if bf16 else x
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    np.testing.assert_allclose(
        rmsnorm_cuda(x, scale).float().cpu().numpy(),
        rmsnorm_ref(x, scale).float().cpu().numpy(),
        rtol=2.0 ** -7 if bf16 else 1e-5, atol=1e-6 if bf16 else 1e-5)


@pytest.mark.parametrize("N,d", [(3072, 1536), (3072, 3072), (8, 1536),
                                 (8, 3072)])
def test_rmsnorm_kernel_bit_exact_at_mamba2_rows(dev, N, d):
    """Kernel and plain version sum the squares in f64 and round once, so
    they agree bit for bit (mamba2's logits check depends on it)."""
    gen = torch.Generator(device=dev).manual_seed(d)
    x = (1.5 * torch.randn((N, d), generator=gen, device=dev)).bfloat16()
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    got, want = rmsnorm_cuda(x, scale), rmsnorm_ref(x, scale)
    assert float((got.float() - want.float()).abs().max()) == 0.0


@pytest.mark.parametrize("N,d", [(512, 4096), (512, 8192), (2048, 4096),
                                 (2048, 8192), (8192, 4096), (8192, 8192),
                                 (8, 4096), (8, 8192)])
def test_rmsnorm_kernel_bit_exact_at_jamba_rows(dev, N, d):
    """jamba's norms (d 4096, the gated norm over d_in 8192) at its
    serving, check and long prefills and its decode: bit for bit
    the plain version, as mamba2's, since its 14 Mamba-2 layers of random
    weights amplify any rounding difference as mamba2's 48 do."""
    gen = torch.Generator(device=dev).manual_seed(N + d)
    x = (1.5 * torch.randn((N, d), generator=gen, device=dev)).bfloat16()
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    got, want = rmsnorm_cuda(x, scale), rmsnorm_ref(x, scale)
    assert float((got.float() - want.float()).abs().max()) == 0.0


@pytest.mark.parametrize("row", range(11))
def test_rmsnorm_kernel_bit_exact_at_train_rows(dev, row):
    """chip_smoke.py's RMSNORM_TRAIN_ROWS, the rows the SSM, MoE and MLA
    train steps give the kernel (mamba2's 2 x 4096 at d 1536 and 3072,
    qwen3-moe's 1 x 4096 and its qk-norm rows of 128, deepseek's latents
    and its MTP head's 1023 positions): bit for bit the plain version."""
    rows = _load_chip_smoke().RMSNORM_TRAIN_ROWS
    assert len(rows) == 11
    N, d = rows[row]
    gen = torch.Generator(device=dev).manual_seed(N + d)
    x = (1.5 * torch.randn((N, d), generator=gen, device=dev)).bfloat16()
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    got, want = rmsnorm_cuda(x, scale), rmsnorm_ref(x, scale)
    assert torch.equal(got, want)


def test_rmsnorm_kernel_refuses_rows_wider_than_it_holds(dev):
    with pytest.raises(ValueError, match="load units"):
        rmsnorm_cuda(torch.zeros((2, 32776), device=dev).bfloat16(),
                     torch.ones(32776, device=dev))


def test_rmsnorm_kernel_unaligned_rows_and_bad_operands(dev):
    """A view 2 bytes off a 16-byte boundary takes the scalar loop."""
    d = 256
    flat = torch.randn(4 * d + 1, device=dev).bfloat16()
    x = flat[1:].view(4, d)
    scale = torch.rand(d, device=dev) + 0.5
    np.testing.assert_allclose(
        rmsnorm_cuda(x, scale).float().cpu().numpy(),
        rmsnorm_ref(x, scale).float().cpu().numpy(), rtol=2.0 ** -7,
        atol=1e-6)
    with pytest.raises(ValueError, match="float32"):
        rmsnorm_cuda(x, scale.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        rmsnorm_cuda(x, scale[:-1])


@pytest.mark.parametrize("case", range(25))
def test_flash_attention_kernel_matches_plain(dev, case):
    """chip_smoke.py's cases: causal and not, GQA and MQA, tails, Dv != Dh,
    q_offset, float32, a head width of no whole 16-byte vector, a
    1024-token prefill, whisper's encoder, cross-attention and decoder,
    granite-20b's MQA and qwen3-32b's GQA at Dh 128, deepseek-v3's MLA
    at Dh 192, Dv 128 (its prefill, 1024 tokens, ragged tails, q_offset,
    float32), jamba's prefills (GQA 32:8 at Dh 128: 8 x 64 tokens,
    2 x 1024 and 1 x 8192), and the train steps' shapes: jamba's 1 x
    2048, qwen3-moe's 1 x 4096 (GQA 32:4) and deepseek's MTP layer over
    1023 positions."""
    assert len(_load_chip_smoke().FA_CASES) == 25
    c = _load_chip_smoke().FA_CASES[case]
    causal, q_offset, bf16 = c[7], c[8], c[9]
    q, k, v = _load_chip_smoke().fa_inputs(torch, c, seed=case, dev=dev)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    assert flash_attention_cuda.launches == before + 1
    tol = 2e-2 if bf16 else 1e-4
    _close(got, attention_ref(q, k, v, causal=causal, q_offset=q_offset),
           tol)


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, KV, Dh, Dv, causal, q_offset, bfloat16)
    (1, 1024, 1024, 4, 4, 80, 80, True, 0, True),    # 16 kv blocks
    (1, 1024, 1024, 4, 2, 80, 80, False, 0, True),
    (2, 130, 130, 4, 1, 30, 30, True, 0, True),      # Dh 30: scalar staging
    (1, 200, 400, 2, 2, 30, 30, False, 0, True),
    (2, 257, 257, 4, 2, 64, 64, True, 0, True),      # Dh 64, tails
    (1, 200, 333, 4, 4, 128, 128, False, 0, True),   # Dh 128, tails
    (1, 256, 256, 2, 1, 128, 64, True, 0, True),     # Dv < Dh
    (1, 100, 300, 4, 2, 80, 80, True, 200, True),    # q_offset, tails
    (2, 17, 150, 4, 4, 64, 64, True, 133, True),     # one decode-like block
    (1, 300, 300, 2, 2, 80, 80, True, 0, False),     # float32, 5 kv blocks
    (1, 700, 700, 4, 4, 192, 128, True, 0, True),    # Dh 192: 11 kv blocks
    (1, 130, 333, 4, 2, 192, 128, False, 0, True),   # Dh 192, GQA, tails
    (1, 100, 300, 2, 2, 176, 64, True, 200, True),   # Dh 176, Dv 64: pads
    (2, 17, 150, 4, 4, 136, 72, True, 133, True),    # Dh 136, Dv 72: pads
    (1, 70, 90, 2, 1, 150, 100, False, 0, True),     # Dh 150: scalar loads
    (1, 200, 200, 2, 2, 192, 128, False, 0, False),  # float32, Dh 192
])
def test_flash_attention_kernel_many_blocks_widths_tails(dev, case):
    """The bf16 tensor-core kernel's double buffer (many kv blocks), its
    head widths 30, 64, 80 and 128, the wide Q/K width (Dh 136 to 192
    with Dv up to 128, padded), ragged Sq and Skv, and q_offset."""
    causal, q_offset, bf16 = case[7], case[8], case[9]
    q, k, v = _load_chip_smoke().fa_inputs(torch, case, seed=sum(case[:7]),
                                           dev=dev)
    got = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    assert got.shape == case[:2] + (case[3], case[6]) and got.dtype == q.dtype
    _close(got, attention_ref(q, k, v, causal=causal, q_offset=q_offset),
           2e-2 if bf16 else 1e-4)


def test_flash_attention_kernel_rejects_bad_shapes(dev):
    q = torch.zeros((1, 8, 4, 32), device=dev)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q, q[:, :, :3], q[:, :, :3].contiguous())
    big = torch.zeros((1, 8, 1, 200), device=dev)       # Dh 200 > 192
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(big, big, big[..., :128].contiguous())
    qk = torch.zeros((1, 8, 1, 192), device=dev)
    wide_v = torch.zeros((1, 8, 1, 160), device=dev)    # Dv 160 > 128
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(qk, qk, wide_v)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_cuda(q, q.bfloat16(), q.bfloat16())


def test_reduced_stablelm_kernel_path_matches_plain_path(dev):
    """The whole serving path on the card at a reduced bf16 stablelm:
    prefill logits through the kernels against the plain versions, and
    the launches a greedy decode makes."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(
        reduced(get_config("stablelm-3b"), layers=2, d_model=160, vocab=512),
        dtype="bfloat16")                       # 4 heads of Dh = 40
    params = tf.compute_params(tf.init_params(cfg, seed=0, device=dev), cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (3, 70)),
                           device=dev)
    kern = tf.forward(params, cfg, {"tokens": toks})
    plain = tf.forward(params, cfg, {"tokens": toks}, use_kernel=False)
    _close(kern, plain, 0.05)
    r0, f0 = rmsnorm_cuda.launches, flash_attention_cuda.launches
    out = serve.greedy_decode(params, cfg, toks.cpu().numpy()[:, :9], 4, 13)
    assert out.shape == (3, 4)
    assert rmsnorm_cuda.launches - r0 == (2 * 2 + 1) * (1 + 9 + 3)
    assert flash_attention_cuda.launches - f0 == 2


def test_whisper_kernel_path_matches_plain_path(dev):
    """whisper-large-v3 at full width and 2 + 2 layers in bf16: encoder
    output and logits through the kernels against the plain versions
    (relative L2 < 0.05, top-1 >= 0.9, chip_smoke's serving bounds), and
    the launches of encode, forward and a decode step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config("whisper-large-v3"), num_layers=2,
                              encoder_layers=2)
    params = tf.compute_params(encdec.init_params(cfg, seed=0, device=dev),
                               cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"frames": torch.randn((2, 1500, 1280), generator=gen,
                                   device=dev),
             "tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=gen, device=dev)}

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    r0, f0 = rmsnorm_cuda.launches, flash_attention_cuda.launches
    enc = encdec.encode(params, cfg, batch["frames"])
    assert (rmsnorm_cuda.launches - r0, flash_attention_cuda.launches - f0) \
        == (5, 2)
    assert rel(enc, encdec.encode(params, cfg, batch["frames"],
                                  use_kernel=False)) < 0.05
    r0, f0 = rmsnorm_cuda.launches, flash_attention_cuda.launches
    kern = encdec.forward(params, cfg, batch)
    assert (rmsnorm_cuda.launches - r0, flash_attention_cuda.launches - f0) \
        == (12, 6)
    plain = encdec.forward(params, cfg, batch, use_kernel=False)
    assert rel(kern, plain) < 0.05
    assert float((kern.argmax(-1) == plain.argmax(-1)).float().mean()) >= 0.9
    cache = encdec.start_cache(params, cfg, enc, 2, 8)
    r0, f0 = rmsnorm_cuda.launches, flash_attention_cuda.launches
    logits, _ = encdec.decode_step(params, cfg, cache,
                                   batch["tokens"][:, :1], 0)
    assert (rmsnorm_cuda.launches - r0, flash_attention_cuda.launches - f0) \
        == (7, 0)
    assert bool(torch.isfinite(logits).all())


def test_qk_norm_and_int8_cache_paths_on_the_card(dev):
    """A reduced bf16 qwen3 (qk-norm through the rmsnorm kernel over rows
    of Dh) through the kernels against the plain versions, and its int8
    KV cache's decode steps finite and written."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=512, vocab=512),
        dtype="bfloat16")                        # 4 heads of Dh = 128
    params = tf.compute_params(tf.init_params(cfg, seed=0, device=dev), cfg)
    toks = torch.randint(0, 512, (3, 40), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    r0 = rmsnorm_cuda.launches
    kern = tf.forward(params, cfg, {"tokens": toks})
    assert rmsnorm_cuda.launches - r0 == 4 * 2 + 1
    _close(kern, tf.forward(params, cfg, {"tokens": toks}, use_kernel=False),
           0.05)
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    cache = tf.init_cache(qcfg, 3, 8, device=dev)
    for t in range(8):
        logits, cache = tf.decode_step(params, qcfg, cache,
                                       toks[:, t:t + 1], t)
        assert bool(torch.isfinite(logits).all())
    assert int(cache["l0"]["k_q"].abs().max()) == 127


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v3-671b"])
def test_moe_and_mla_kernel_paths_match_plain_path(dev, arch):
    """A reduced bf16 qwen3-moe and deepseek-v3 (MLA at its own widths:
    ranks 1536 / 512, Dh 192 and Dv 128) through the kernels against the
    plain versions within chip_smoke's serving bounds (relative L2 and
    top-1), the launches of a forward (4L + 1 norms, L flash attentions)
    and of a greedy decode, and the decode steps against the forward.
    Every token takes all 4 experts (top-4), so that no routing decision
    can flip between the paths; chip_smoke's phase 6d reports flips at
    full width."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(reduced(get_config(arch), d_model=256,
                                      vocab=512),
                              dtype="bfloat16", mtp_depth=0)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           top_k=4))
    if cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla=get_config(arch).mla)
    params = tf.compute_params(tf.init_params(cfg, seed=0, device=dev), cfg)
    toks = torch.randint(0, 512, (2, 40), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    smoke = _load_chip_smoke()

    def agree(got, want):
        rel, top1 = smoke._agreement(torch, got, want)
        assert rel < smoke.LOGITS_REL_TOL and top1 >= smoke.TOP1_MIN

    r0, f0 = rmsnorm_cuda.launches, flash_attention_cuda.launches
    kern = tf.forward(params, cfg, {"tokens": toks})
    assert (rmsnorm_cuda.launches - r0, flash_attention_cuda.launches - f0) \
        == (4 * 2 + 1, 2)
    agree(kern, tf.forward(params, cfg, {"tokens": toks}, use_kernel=False))
    cache = tf.init_cache(cfg, 2, 40, device=dev)
    steps = [tf.decode_step(params, cfg, cache, toks[:, t:t + 1], t)[0]
             for t in range(40)]
    agree(torch.cat(steps, dim=1), kern)
    r0, f0 = rmsnorm_cuda.launches, flash_attention_cuda.launches
    out = serve.greedy_decode(params, cfg, toks.cpu().numpy()[:, :9], 4, 13)
    assert out.shape == (2, 4)
    assert (rmsnorm_cuda.launches - r0, flash_attention_cuda.launches - f0) \
        == ((4 * 2 + 1) * (1 + 9 + 3), 2)


# ---------------------------------------------------------------------------
# ssd_scan and the mamba2 serving path
# ---------------------------------------------------------------------------
def _scan_inputs(dims, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(dims, generator=gen, device=dev),
            torch.rand(dims[:3], generator=gen, device=dev))


@pytest.mark.parametrize("case", range(10))
def test_ssd_scan_kernel_matches_plain(dev, case):
    """chip_smoke.py's cases: mamba2-780m's prefill, a long prefill,
    jamba's 128 heads of (64, 64) over 1, 4 and 32 chunks (its serving,
    check and long prefills), the JAX package's test dims, a P·N of no
    whole float4, a partial block."""
    assert len(_load_chip_smoke().SSD_CASES) == 10
    dims = _load_chip_smoke().SSD_CASES[case]
    states, dec = _scan_inputs(dims, case, dev)
    before = ssd_scan_cuda.launches
    got = ssd_ops.ssd_scan(states, dec)
    assert ssd_scan_cuda.launches == before + 1
    for g, w in zip(got, ssd_scan_ref(states, dec)):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5)


def test_ssd_scan_kernel_initial_state_unaligned_and_bad_operands(dev):
    """An initial state; a states view 4 bytes off a 16-byte boundary (the
    scalar kernel); operands the kernel refuses."""
    dims = (2, 3, 4, 8, 16)
    states, dec = _scan_inputs(dims, 9, dev)
    h0 = torch.randn((2, 4, 8, 16), device=dev)
    for g, w in zip(ssd_scan_cuda(states, dec, h0),
                    ssd_scan_ref(states, dec, h0)):
        _close(g, w, 1e-5)
    flat = torch.randn(states.numel() + 1, device=dev)
    off = flat[1:].view(dims)
    for g, w in zip(ssd_scan_cuda(off, dec), ssd_scan_ref(off, dec)):
        _close(g, w, 1e-5)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan_cuda(states.bfloat16(), dec)
    with pytest.raises(ValueError, match="shape"):
        ssd_scan_cuda(states, dec[:, :2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_cuda(states.transpose(3, 4), dec)


def test_reduced_mamba2_kernel_path_matches_plain_path(dev):
    """The whole SSM serving path on the card at a reduced bf16 mamba2:
    prefill logits through the kernels against the plain versions, and
    the launches a greedy decode makes."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(
        reduced(get_config("mamba2-780m"), layers=2, d_model=128, vocab=512),
        dtype="bfloat16")
    params = tf.compute_params(tf.init_params(cfg, seed=0, device=dev), cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (3, 70)),
                           device=dev)
    kern = tf.forward(params, cfg, {"tokens": toks})
    plain = tf.forward(params, cfg, {"tokens": toks}, use_kernel=False)
    _close(kern, plain, 0.05)
    r0, s0 = rmsnorm_cuda.launches, ssd_scan_cuda.launches
    out = serve.greedy_decode(params, cfg, toks.cpu().numpy()[:, :20], 4, 24)
    assert out.shape == (3, 4)
    assert rmsnorm_cuda.launches - r0 == (2 * 2 + 1) * (1 + 20 + 3)
    assert ssd_scan_cuda.launches - s0 == 2


@pytest.mark.parametrize("dims", [(8, 1, 128, 64, 64), (2, 4, 128, 64, 64),
                                  (1, 32, 128, 64, 64)])
def test_ssd_scan_kernel_bit_exact_at_jamba_heads(dev, dims):
    """jamba's 128 heads of P = 64 and N = 64 at its serving, check and
    long prefills (1, 4 and 32 chunks) and from an initial state: bit for
    bit the plain version (the same unfused multiply-add), which jamba's
    logits check rests on."""
    states, dec = _scan_inputs(dims, 11, dev)
    h0 = torch.randn((dims[0],) + dims[2:], device=dev)
    for g, w in zip(ssd_scan_cuda(states, dec, h0),
                    ssd_scan_ref(states, dec, h0)):
        assert float((g - w).abs().max()) == 0.0


def _reduced_jamba(dev, dtype, layers=16):
    """A reduced jamba (16 layers: two groups, 14 Mamba-2 and 2 attention
    layers) with every token on all 4 experts, so that no routing
    decision can flip between the paths."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tf
    cfg = reduced(get_config("jamba-v0.1-52b"), layers=layers, d_model=256,
                  vocab=512)
    cfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, top_k=4))
    return cfg, tf.compute_params(tf.init_params(cfg, seed=0, device=dev),
                                  cfg)


def test_reduced_hybrid_kernel_path_matches_plain_path(dev):
    """The hybrid serving path on the card at a reduced bf16 jamba: prefill
    logits through the kernels against the plain versions within
    chip_smoke's bounds (relative L2 and top-1), over 3 chunks of 8 and a
    padded tail; the launches of a forward (2L + L_ssm + 1 norms, one
    flash attention per attention layer, one ssd_scan per Mamba-2 layer)
    and of a greedy decode (the norms alone a step)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    cfg, params = _reduced_jamba(dev, "bfloat16")
    smoke = _load_chip_smoke()
    toks = torch.randint(0, 512, (2, 30), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    counts = (rmsnorm_cuda, flash_attention_cuda, ssd_scan_cuda)
    before = [f.launches for f in counts]
    kern = tf.forward(params, cfg, {"tokens": toks})
    assert [f.launches - b for f, b in zip(counts, before)] == [47, 2, 14]
    rel, top1 = smoke._agreement(
        torch, kern, tf.forward(params, cfg, {"tokens": toks},
                                use_kernel=False))
    assert rel < smoke.LOGITS_REL_TOL and top1 >= smoke.TOP1_MIN
    before = [f.launches for f in counts]
    out = serve.greedy_decode(params, cfg, toks.cpu().numpy()[:1, :9], 4, 13)
    assert out.shape == (1, 4)
    assert [f.launches - b for f, b in zip(counts, before)] == \
        [47 * (1 + 9 + 3), 2, 14]


def test_reduced_hybrid_decode_over_the_mixed_cache_matches_forward(dev):
    """Decode steps over the mixed cache (k/v at position 4, the SSM state
    and conv tail elsewhere, written in place) against the teacher-forced
    forward through the kernels, in float32 where the two agree to
    rounding: within 1e-4."""
    from repro_torch.models import transformer as tf
    cfg, params = _reduced_jamba(dev, "float32")
    toks = torch.randint(0, 512, (2, 20), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    cache = tf.init_cache(cfg, 2, 20, device=dev)
    steps = [tf.decode_step(params, cfg, cache, toks[:, t:t + 1], t)[0]
             for t in range(20)]
    fwd = tf.forward(params, cfg, {"tokens": toks})
    _close(torch.cat(steps, dim=1), fwd, 1e-4)
    assert set(cache["l4"]) == {"k", "v"} and float(
        cache["l3"]["h"].abs().max()) > 0


# ---------------------------------------------------------------------------
# A rolling-horizon day as one CUDA-graph replay (`api.solve_day`)
# ---------------------------------------------------------------------------
DAY_STEPS = dict(cold_steps=48, warm_steps=16)


def _day_policy(name):
    from repro_torch.core.api import CR1, CR2
    return CR1(lam=1.45) if name == "cr1" else CR2(cap_frac=0.78, outer=2)


def _day_stack(n_ticks):
    from repro_torch.core.carbon import ForecastStream
    stream = ForecastStream.caiso(n_ticks=n_ticks, horizon=T, seed=7)
    return np.stack([stream.forecast(t) for t in range(n_ticks)])


def _eager_day(p, policy, stack, ctx):
    """`_day_impl` called directly: the day's tick loop run eagerly on
    the card, launch by launch."""
    from repro_torch.core import api
    _, _, day, inputs = api._day_setup(p, policy, stack, ctx,
                                       DAY_STEPS["cold_steps"],
                                       DAY_STEPS["warm_steps"])
    with torch.no_grad():
        out = api._day_impl(day, inputs)
    return day, [t.cpu().numpy() for t in out]


def _day_out(res):
    st = res.last.state
    return [res.committed, res.last.D, None,
            *(t.cpu().numpy() for t in (st.x, st.lam_eq, st.lam_in, st.mu))]


def _max_diff(got, want):
    return max(float(np.abs(g - w).max(initial=0.0))
               for g, w in zip(got, want) if g is not None)


def _expected_day_launches(policy, n_ticks):
    """Per replay at k_steps = 8: ceil(steps / 8) al_step calls a round;
    dr_features once a tick for the final penalties and, for CR2, once for
    the targets and once per round for the equality residual."""
    rounds = 2 if policy == "cr2" else 1
    calls = -(-DAY_STEPS["cold_steps"] // 8) + (n_ticks - 1) * -(
        -DAY_STEPS["warm_steps"] // 8)
    return {"al_step": rounds * calls,
            "dr_features": n_ticks * (rounds + 2 if policy == "cr2" else 1)}


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_day_graph_replay_matches_eager_day(dev, fleets, policy):
    """The replay against the same day run eagerly through the same
    kernels, at W = 130 over 4 ticks: within 1e-6 NP (both launch the same
    kernels on the same inputs in the same order, so bitwise is
    expected)."""
    from repro_torch.core.api import SolveContext, solve_day
    p, pol, stack = fleets[130], _day_policy(policy), _day_stack(4)
    res = solve_day(p, pol, stack, ctx=SolveContext(), **DAY_STEPS)
    _, eager = _eager_day(p, pol, stack, SolveContext())
    assert _max_diff(_day_out(res), eager) <= 1e-6
    assert res.committed.shape == (4, 130)
    assert np.isfinite(res.committed).all()
    assert res.last.preservation_violation < 1e-3


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_day_graph_captures_once_and_counts_each_replay(dev, fleets,
                                                        policy):
    """The first day of a configuration captures; the second replays
    without capturing, and each replay adds the launches the capture saw,
    which the device's own trace confirms."""
    from repro_torch.core import api
    from repro_torch.core.api import SolveContext, solve_day
    from repro_torch.core.daygraph import DAY_GRAPHS
    p, pol, stack = fleets[130], _day_policy(policy), _day_stack(3)
    ctx = SolveContext()
    key = api._day_setup(p, pol, stack, ctx, DAY_STEPS["cold_steps"],
                         DAY_STEPS["warm_steps"])[2]
    DAY_GRAPHS._graphs.pop(key, None)
    n0 = DAY_GRAPHS.captures
    solve_day(p, pol, stack, ctx=ctx, **DAY_STEPS)
    assert DAY_GRAPHS.captures == n0 + 1
    want = _expected_day_launches(policy, 3)
    assert DAY_GRAPHS.get(key).launches == want

    def replay():
        return solve_day(p, pol, stack, ctx=ctx, **DAY_STEPS)

    before = (al_step_cuda.launches, dr_features_cuda.launches)
    replay()
    assert DAY_GRAPHS.captures == n0 + 1
    assert (al_step_cuda.launches - before[0],
            dr_features_cuda.launches - before[1]) == \
        (want["al_step"], want["dr_features"])
    on_device = _load_chip_smoke().device_launches(
        torch, f"{policy} day", replay, want)
    assert DAY_GRAPHS.captures == n0 + 1
    assert on_device == want


def test_day_graph_another_fleet_of_the_same_shape(dev, fleets):
    """A second fleet of the same shape replays the captured day with its
    own data and gets its own answer."""
    import dataclasses

    from repro_torch.core.api import SolveContext, solve_day
    from repro_torch.core.daygraph import DAY_GRAPHS
    pol, stack, ctx = _day_policy("cr2"), _day_stack(4), SolveContext()
    p = fleets[130]
    big = fleets[10_000]
    q = dataclasses.replace(big, **{
        n: getattr(big, n)[:130] for n in ("usage", "entitlement", "k",
                                           "rts_coeffs", "betas", "x2_kind",
                                           "jobs", "is_batch")},
        names=None)
    first = solve_day(p, pol, stack, ctx=ctx, **DAY_STEPS)
    n0 = DAY_GRAPHS.captures
    other = solve_day(q, pol, stack, ctx=ctx, **DAY_STEPS)
    assert DAY_GRAPHS.captures == n0
    _, eager = _eager_day(q, pol, stack, ctx)
    assert _max_diff(_day_out(other), eager) <= 1e-6
    assert np.abs(other.committed - first.committed).max() > 1e-3


def test_day_graph_donated_state_aliases_the_buffers(dev, fleets):
    """`donate=False` states are clones that survive a later replay;
    `donate=True` states alias the graph's output buffers, which the next
    replay overwrites."""
    from repro_torch.core import api
    from repro_torch.core.api import SolveContext, solve_day
    from repro_torch.core.daygraph import DAY_GRAPHS
    pol, stack = _day_policy("cr1"), _day_stack(4)
    p = fleets[130]
    kept = solve_day(p, pol, stack, ctx=SolveContext(), **DAY_STEPS)
    x_kept = kept.last.state.x.clone()
    shifted = solve_day(p, pol, stack[:, ::-1].copy(),
                        ctx=SolveContext(donate=True), **DAY_STEPS)
    key = api._day_setup(p, pol, stack, SolveContext(),
                         DAY_STEPS["cold_steps"], DAY_STEPS["warm_steps"])[2]
    outputs = DAY_GRAPHS.get(key).outputs
    assert shifted.last.state.x.data_ptr() == outputs[3].data_ptr()
    assert kept.last.state.x.data_ptr() != outputs[3].data_ptr()
    x_shifted = shifted.last.state.x.clone()
    assert not torch.equal(x_shifted, x_kept)
    again = solve_day(p, pol, stack, ctx=SolveContext(), **DAY_STEPS)
    assert torch.equal(kept.last.state.x, x_kept)
    assert torch.equal(again.last.state.x, x_kept)
    assert torch.equal(shifted.last.state.x, x_kept)   # overwritten


def test_day_without_kernels_runs_eagerly_on_the_card(dev, fleets):
    """`use_kernel=False` on CUDA: the generic engine's autograd day runs
    launch by launch and is not captured; it agrees with the fused day at
    the solution-level bound."""
    from repro_torch.core.api import SolveContext, solve_day
    from repro_torch.core.daygraph import DAY_GRAPHS
    pol, stack, p = _day_policy("cr1"), _day_stack(2), fleets[130]
    n0, a0 = DAY_GRAPHS.captures, al_step_cuda.launches
    generic = solve_day(p, pol, stack, ctx=SolveContext(use_kernel=False),
                        **DAY_STEPS)
    assert (DAY_GRAPHS.captures, al_step_cuda.launches) == (n0, a0)
    fused = solve_day(p, pol, stack, ctx=SolveContext(), **DAY_STEPS)
    assert abs(generic.last.carbon_reduction_pct
               - fused.last.carbon_reduction_pct) < 0.05


# ---------------------------------------------------------------------------
# Batched lanes: al_step with a lane axis, stacked dr_features rows, sweeps
# ---------------------------------------------------------------------------
def _lane_args(fleets, N, mode, shared, bf16, T_, dev, seed=0, **kw):
    """chip_smoke's lane inputs on the W = 130 fleet at horizon T_: the
    per-lane argument lists and the stacked ones, on the card."""
    lanes, stacked = _load_chip_smoke().al_step_lane_inputs(
        np, fleets[130], N, mode=mode, seed=seed, shared=shared, **kw)

    def prep(arrs):
        out = [_f32(a, dev) for a in arrs]
        hours = torch.arange(T_, device=dev) % T
        out = [a[..., hours].contiguous() if a.shape[-1] == T else a
               for a in out]
        if bf16:
            out[1], out[2] = out[1].bfloat16(), out[2].bfloat16()
        return out

    return [prep(a) for a in lanes], prep(stacked)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("T_", [24, 48, 45])
@pytest.mark.parametrize("N", [1, 3, 16])
def test_al_step_lanes_are_one_lane_calls_bitwise(dev, fleets, N, T_, shared,
                                                  bf16):
    """N lanes in one launch equal N one-lane calls bit for bit: mixed
    rows ordered by kind, 8 steps, per-lane scalars (lam, mu, lr scale,
    t0), shared or per-lane fleet constants and carbon rows."""
    for mode in ("cr1", "cr2"):
        lanes, args = _lane_args(fleets, N, mode, shared, bf16, T_, dev,
                                 seed=N + T_, rts_only=False, stable=True)
        kw = dict(mode=mode, k_steps=8)
        before = al_step_cuda.launches
        got = al_step_cuda(*args, **kw)
        assert al_step_cuda.launches == before + 1
        for i, one in enumerate(lanes):
            for g, o in zip(got, al_step_cuda(*one, **kw)):
                assert g.dtype == o.dtype
                assert torch.equal(g[i], o), (mode, i)


@pytest.mark.parametrize("shared", [False, True])
def test_al_step_lanes_match_plain(dev, fleets, shared):
    """The batched kernel against its plain version at the one-lane
    tolerance (RTS rows, 8 steps)."""
    lanes, args = _lane_args(fleets, 4, "cr2", shared, False, T, dev, seed=3)
    kw = dict(mode="cr2", k_steps=8)
    for g, w in zip(al_step_cuda(*args, **kw), al_step_ref(*args, **kw)):
        _close(g, w, 1e-5)


def test_al_step_lanes_reject_bad_operands(dev, fleets):
    _, args = _lane_args(fleets, 3, "cr1", False, False, T, dev)
    bad = list(args)
    bad[9] = args[9][:2]
    with pytest.raises(ValueError, match="scal"):
        al_step_cuda(*bad, mode="cr1", k_steps=1)
    bad = list(args)
    bad[3] = args[3][:2]
    with pytest.raises(ValueError, match="usage"):
        al_step_cuda(*bad, mode="cr1", k_steps=1)


def test_dr_features_on_stacked_rows(dev, fleets):
    """`fleet_penalties` on (N, W, T) lanes: one dr_features launch for
    all N·W rows, each lane's penalties those of its one-lane call."""
    import dataclasses
    from repro_torch.core.fleet_solver import device_view, fleet_penalties
    p = device_view(fleets[130], dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    D = 0.3 * torch.randn((5,) + tuple(p.usage.shape), generator=gen,
                          device=dev)
    scale = torch.linspace(0.8, 1.2, 5, device=dev)[:, None, None]
    for q in (p, dataclasses.replace(p, usage=p.usage * scale,
                                     jobs=p.jobs * scale)):
        before = dr_features_cuda.launches
        pens = fleet_penalties(q, D)
        assert dr_features_cuda.launches == before + 1
        for i in range(5):
            one = q if q.usage.dim() == 2 else dataclasses.replace(
                q, usage=q.usage[i], jobs=q.jobs[i])
            _close(pens[i], fleet_penalties(one, D[i]), 1e-6)


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_sweep_lanes_match_solve_loop(dev, fleets, policy):
    """A sweep at W = 130 through the kernels: ceil(steps / 8) al_step
    launches per round for all lanes, each lane within 0.01 pp of its
    `solve()`."""
    from repro_torch.core.api import CR1, CR2, SolveContext, solve, sweep
    p = fleets[130]
    pols = ([CR1(lam=lam) for lam in (1.0, 1.45, 2.2)] if policy == "cr1"
            else [CR2(cap_frac=c, outer=2) for c in (0.74, 0.82)])
    ctx = SolveContext(steps=100)
    before = al_step_cuda.launches
    got = sweep(p, pols, ctx=ctx)
    assert al_step_cuda.launches - before == getattr(pols[0], "outer",
                                                     1) * 13
    for pl, r in zip(pols, got):
        one = solve(p, pl, ctx=ctx)
        assert abs(r.carbon_reduction_pct - one.carbon_reduction_pct) < 0.01
        assert abs(r.total_penalty_pct - one.total_penalty_pct) < 0.01


def test_overloaded_rows_end_at_their_nearest_day_sum(dev, fleets):
    """Usage jittered above entitlement (FleetJitter) inverts some hours'
    box (U - E > 0.5 E); `_bounds` keeps lo <= hi, so the kernel's day
    projection, like its plain version's clip, ends every batch day at the
    nearest sum its box allows (with lo > hi it held such hours at lo and
    left days up to 103 NP·h off at W = 10,000)."""
    from repro_torch.core.api import CR1, SolveContext, solve
    from repro_torch.core.scenario import FleetJitter
    p = fleets[130]
    stack = FleetJitter(2, seed=2, usage_sigma=0.6,
                        entitlement_sigma=0.0).generate(p)
    cs = _load_chip_smoke()
    for s in range(stack.S):
        q = stack.problem(p, s)
        isb = np.asarray(q.is_batch)
        assert (np.asarray(q.usage)[isb]
                > 1.5 * np.asarray(q.entitlement)[isb, None]).any()
        r = solve(q, CR1(), ctx=SolveContext(steps=80))
        gap, n_days = cs.day_sum_gap(np, q, r.D)
        assert n_days > 0 and gap < 1e-3


# ---------------------------------------------------------------------------
# CR3, the baselines and the SLSQP reference
# ---------------------------------------------------------------------------
def test_cr3_kernel_path_matches_plain(dev, fleets):
    """CR3 at W = 130 through dr_features (one launch an inner step and one
    a round) against the plain path: off the hinge ties the kernel path's
    closed-form backward takes the plain path's gradient."""
    from repro_torch.core.api import CR3, SolveContext, solve
    p = fleets[130]
    ctx = SolveContext(steps=150)
    before = dr_features_cuda.launches
    got = solve(p, CR3(), ctx=ctx)
    rounds = got.iters // (150 * 3)
    assert dr_features_cuda.launches - before == rounds * (150 * 3 + 1)
    want = solve(p, CR3(), ctx=SolveContext(steps=150, use_kernel=False))
    assert got.iters == want.iters and got.balanced == want.balanced
    assert got.extras["rho"] == pytest.approx(want.extras["rho"], rel=1e-4)
    assert abs(got.carbon_reduction_pct - want.carbon_reduction_pct) < 0.05
    assert abs(got.total_penalty_pct - want.total_penalty_pct) < 0.05
    assert got.preservation_violation < 1e-3


def test_cr3_gradient_through_the_kernel_is_the_plain_one(dev, fleets):
    """CR3's objective gradient through dr_features: off the ties the
    plain path's bit for bit on the card; at D = 0, every running sum a
    tie, the closed form's strict `>` as on the CPU."""
    from repro_torch.core.fleet_solver import device_view, fleet_penalties

    def grad(D0, device, uk):
        p = device_view(fleets[130], torch.device(device))
        D = _f32(D0, device).requires_grad_(True)
        (g,) = torch.autograd.grad(
            (fleet_penalties(p, D, uk) / p.entitlement).sum(), D)
        return g.cpu()

    D0 = np.random.default_rng(3).normal(0.0, 0.05, (130, T))
    torch.testing.assert_close(grad(D0, dev, True), grad(D0, dev, False),
                               rtol=0, atol=0)
    zero = np.zeros((130, T))
    torch.testing.assert_close(grad(zero, dev, True),
                               grad(zero, "cpu", True), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("policy", ["b1", "b3"])
def test_baselines_launch_dr_features_once(dev, fleets, policy):
    from repro_torch.core.api import B1, B3, SolveContext, solve
    p = fleets[130]
    pol = B1(F=0.75) if policy == "b1" else B3(depth=0.3)
    before = dr_features_cuda.launches
    got = solve(p, pol)
    assert dr_features_cuda.launches - before == 1
    plain = solve(p, pol, ctx=SolveContext(use_kernel=False))
    np.testing.assert_array_equal(got.D, plain.D)
    assert got.total_penalty_pct == pytest.approx(plain.total_penalty_pct,
                                                  rel=1e-5)


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_slsqp_float64_on_the_card_matches_the_cpu(dev, fleets, policy):
    """The SLSQP reference with its functions in float64 on the card
    against the same call on the CPU."""
    from repro_torch.core import policies, solver
    from repro_torch.core.carbon import caiso_2021
    tpl = fleets["templates"]
    dr = policies.DRProblem(
        models=tuple(tpl[n] for n in ("RTS1", "RTS2", "AITraining",
                                      "DataPipeline")),
        mci=caiso_2021(T).mci)
    results = []
    for d in ("cuda", "cpu"):
        spec = (policies.cr1_spec(dr, 1.45) if policy == "cr1"
                else policies.cr2_spec(dr, 0.78, device=d))
        results.append(solver.solve_slsqp(spec, maxiter=60, device=d))
    got, want = results
    assert got.nit == want.nit
    assert abs(got.carbon_reduction_pct - want.carbon_reduction_pct) < 0.01
    assert abs(got.total_penalty_pct - want.total_penalty_pct) < 0.01


def test_slsqp_two_calls_in_one_process_are_bitwise_equal(dev, fleets):
    """The SLSQP reference repeats on the card: two calls of CR1 in one
    process take bitwise-equal iterates to a bitwise-equal plan
    (`scripts/port_slsqp_repeat.py` looks op by op)."""
    from repro_torch.core import policies, solver
    from repro_torch.core.carbon import caiso_2021
    tpl = fleets["templates"]
    dr = policies.DRProblem(
        models=tuple(tpl[n] for n in ("RTS1", "RTS2", "AITraining",
                                      "DataPipeline")),
        mci=caiso_2021(T).mci)
    spec = policies.cr1_spec(dr, 1.45)
    its = ([], [])
    runs = [solver.solve_slsqp(spec, maxiter=80, callback=lambda x, i=i:
                               its[i].append(np.array(x)))
            for i in range(2)]
    assert len(its[0]) == len(its[1]) > 0
    for a, b in zip(*its):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(runs[0].D, runs[1].D)


# ---------------------------------------------------------------------------
# Multi-region fleets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k_steps", [1, 8])
@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_al_step_kernel_per_row_carbon_and_steps(dev, fleets, mode, k_steps):
    """A multi-region solve's operands: a carbon row per fleet row (W, T)
    and per-row step multipliers in rowp col 11, against the plain
    version (RTS rows over 8 steps, hinge-stable mixed rows over one)."""
    args = _al_inputs(fleets, 10_000, mode, seed=6 + k_steps, dev=dev,
                      rts_only=k_steps == 8, stable=True, per_row_cvec=True,
                      step_rows=True)
    assert args[8].shape == (10_000, T)
    assert float(args[7][:, 11].std()) > 0.1
    kw = dict(mode=mode, k_steps=k_steps)
    for g, w in zip(al_step_cuda(*args, **kw), al_step_ref(*args, **kw)):
        _close(g, w, 1e-5)


def test_region_sums_repeat_bitwise_on_the_card(dev, fleets):
    """The per-region reductions and the normalizers built on them are
    the same bit for bit call after call on the card."""
    from repro_torch.core import regional
    from repro_torch.core.fleet_solver import (device_view,
                                               synthetic_regional_fleet)
    p = synthetic_regional_fleet(3000, ["CA", "TX", "NY"], hours=T, seed=0,
                                 utc_offsets="auto",
                                 templates=fleets["templates"])
    view = device_view(p, dev)
    x = view.usage.sum(1)
    for fn in (lambda: regional.region_sum(x, view.region,
                                           view.region_index),
               lambda: regional.segment_sum(view.usage, view.region, 3),
               lambda: regional.cr1_norms(view),
               lambda: regional.cr2_norms(view, x)):
        a, b = fn(), fn()
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)
    want = regional.region_totals(p.region, p.usage, 3)
    np.testing.assert_allclose(
        regional.segment_sum(view.usage, view.region, 3).cpu().numpy(),
        want, rtol=1e-6)


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_multiregion_fused_matches_generic_on_the_card(dev, fleets, policy):
    """CR1/CR2 on an R = 3 fleet through al_step (per-row carbon rows and
    steps) against the generic engine, within 0.05 pp; one al_step launch
    per 8 steps of each AL round."""
    from repro_torch.core.api import CR1, CR2, SolveContext, solve
    from repro_torch.core.fleet_solver import synthetic_regional_fleet
    p = synthetic_regional_fleet(3000, ["CA", "TX", "NY"], hours=T, seed=0,
                                 utc_offsets="auto", topology=None,
                                 templates=fleets["templates"])
    pol = CR1(lam=1.45) if policy == "cr1" else CR2(cap_frac=0.78, outer=2)
    before = al_step_cuda.launches
    got = solve(p, pol, ctx=SolveContext(steps=200))
    rounds = 1 if policy == "cr1" else 2
    assert al_step_cuda.launches - before == rounds * 200 // 8
    want = solve(p, pol, ctx=SolveContext(steps=200, use_kernel=False))
    assert abs(got.carbon_reduction_pct - want.carbon_reduction_pct) < 0.05
    assert abs(got.total_penalty_pct - want.total_penalty_pct) < 0.05
    assert got.preservation_violation < 1e-3


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_region_sum_index_is_the_mask_sum_on_the_card(dev, order):
    """The index-select per-region sum equals the mask form
    (`x[mask].sum()`, which reads a count on the host) bit for bit on
    the card, at the main path's width."""
    from repro_torch.core import regional
    from repro_torch.core.fleet_solver import region_index
    rng = np.random.default_rng(11)
    region = np.sort(rng.integers(0, 3, 10_000))
    if order == "unsorted":
        region = rng.permutation(region)
    x = _f32(rng.normal(0.0, 3.0, 10_000) * 10.0 ** rng.integers(
        -3, 4, 10_000), dev)
    reg = torch.as_tensor(region, device=dev)
    got = regional.region_sum(x, reg, region_index(region, 3, dev))
    want = torch.zeros_like(x)
    for r in range(3):
        mask = reg == r
        want = torch.where(mask, x[mask].sum(), want)
    assert torch.equal(got, want)


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_multiregion_day_graph_replay_matches_eager_day(dev, fleets, policy):
    """A multi-region day (W = 130, R = 3, an (n_ticks, R, T) stack) is one
    captured graph whose replay equals the same day run eagerly through
    the same kernels, bitwise, with the single-region day's launches at
    the same budgets."""
    from repro_torch.core import api
    from repro_torch.core.api import SolveContext, solve_day
    from repro_torch.core.carbon import ForecastStream
    from repro_torch.core.daygraph import DAY_GRAPHS
    from repro_torch.core.fleet_solver import synthetic_regional_fleet
    p = synthetic_regional_fleet(130, ["CA", "TX", "NY"], hours=T, seed=0,
                                 utc_offsets="auto",
                                 templates=fleets["templates"])
    streams = ForecastStream.regional(np.tile(np.asarray(p.mci), (1, 2)),
                                      horizon=T, seed=7)
    stack = np.stack([np.stack([s.forecast(t) for s in streams])
                      for t in range(3)])
    pol, ctx = _day_policy(policy), SolveContext()
    key = api._day_setup(p, pol, stack, ctx, DAY_STEPS["cold_steps"],
                         DAY_STEPS["warm_steps"])[2]
    assert key.R == 3 and sum(key.region_counts) == 130
    DAY_GRAPHS._graphs.pop(key, None)
    n0 = DAY_GRAPHS.captures
    solve_day(p, pol, stack, ctx=ctx, **DAY_STEPS)
    before = (al_step_cuda.launches, dr_features_cuda.launches)
    res = solve_day(p, pol, stack, ctx=ctx, **DAY_STEPS)
    assert DAY_GRAPHS.captures == n0 + 1
    want = _expected_day_launches(policy, 3)
    assert (al_step_cuda.launches - before[0],
            dr_features_cuda.launches - before[1]) == \
        (want["al_step"], want["dr_features"])
    _, eager = _eager_day(p, pol, stack, ctx)
    assert _max_diff(_day_out(res), eager) == 0.0
    assert res.committed.shape == (3, 130)
    assert np.isfinite(res.committed).all()
    assert res.last.preservation_violation < 1e-3


# ---------------------------------------------------------------------------
# Guardrails and observability
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_sanitized_day_graph(dev, fleets, policy):
    """A sanitized day is a graph of its own: its replay is bitwise the
    unsanitized replay at the same launches, a NaN in one tick raises after
    the replay, and a clean day replayed on the same graph then passes
    (the flag restarts at 0 on every replay)."""
    from repro_torch.analysis import SanitizeError
    from repro_torch.core.api import SolveContext, solve_day
    from repro_torch.core.daygraph import DAY_GRAPHS
    p, pol, stack = fleets[130], _day_policy(policy), _day_stack(4)

    def day(s, sanitize):
        return solve_day(p, pol, s, ctx=SolveContext(sanitize=sanitize),
                         **DAY_STEPS)

    plain = day(stack, False)
    n0 = DAY_GRAPHS.captures
    day(stack, True)
    assert DAY_GRAPHS.captures == n0 + 1
    before = (al_step_cuda.launches, dr_features_cuda.launches)
    san = day(stack, True)
    want = _expected_day_launches(policy, 4)
    assert (al_step_cuda.launches - before[0],
            dr_features_cuda.launches - before[1]) == \
        (want["al_step"], want["dr_features"])
    np.testing.assert_array_equal(san.committed, plain.committed)
    assert torch.equal(san.last.state.x, plain.last.state.x)
    bad = stack.copy()
    bad[2, 11] = np.nan
    with pytest.raises(SanitizeError, match="al-fused-inner: non-finite "
                                            "values in x"):
        day(bad, True)
    again = day(stack, True)
    assert DAY_GRAPHS.captures == n0 + 1
    np.testing.assert_array_equal(again.committed, plain.committed)


def test_ledger_day_under_recompile_guard(dev, fleets, tmp_path):
    """A ledger day of a configuration already captured compiles nothing,
    launches what a day without the ledger launches, and commits the same
    plan."""
    from repro_torch.analysis import recompile_guard
    from repro_torch.core.carbon import ForecastStream
    from repro_torch.core.streaming import RollingHorizonSolver
    from repro_torch.obs import read_events
    p = fleets[130]
    stream = ForecastStream.caiso(n_ticks=9, horizon=T, seed=7)
    kw = dict(policy=_day_policy("cr1"), **DAY_STEPS)
    path = tmp_path / "day.jsonl"
    led = RollingHorizonSolver(p, stream, events=str(path),
                               guard_recompiles=True, **kw)
    bare = RollingHorizonSolver(p, stream, **kw)
    for s in (led, bare):
        s.run_scanned(3)
        s.run_scanned(3)
    n0 = al_step_cuda.launches
    with recompile_guard(0) as stats:
        got = led.run_scanned(3)
    n1 = al_step_cuda.launches
    want = bare.run_scanned(3)
    n2 = al_step_cuda.launches
    assert (stats.captures, stats.builds) == (0, 0)
    assert n1 - n0 == n2 - n1 == 3 * -(-DAY_STEPS["warm_steps"] // 8)
    np.testing.assert_array_equal(got.committed, want.committed)
    ticks = [r for r in read_events(path) if r["kind"] == "tick"]
    assert [t["dispatches"] for t in ticks] == [1, 0, 0] * 3
    assert read_events(path)[0]["host"]["platform"] == "cuda"


def test_span_synchronizes_a_cuda_tensor(dev):
    from repro_torch.obs import span
    x = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with span("matmul") as sp:
        start.record()
        y = sp.bind(x @ x @ x)
        end.record()
    assert end.query()                  # the span waited for the device
    assert sp.elapsed_s * 1e3 >= start.elapsed_time(end)
    assert torch.isfinite(y).all()


def test_profile_writes_its_file(dev, tmp_path):
    from repro_torch.obs import profile
    with profile(tmp_path) as prof:
        (torch.ones(1 << 20, device=dev) * 2).sum()
        torch.cuda.synchronize()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any(e.device_type.name == "CUDA" for e in prof.events())


# ---------------------------------------------------------------------------
# NaN through the penalty hinges; training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k_steps", [1, 4])
@pytest.mark.parametrize("field", ["usage", "jobs"])
@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_al_step_keeps_a_nan_in_usage_or_jobs_as_its_plain_version(
        dev, fleets, mode, field, k_steps):
    """A NaN in one hour of one RTS row's and one batch row's usage (or
    jobs) reaches x after k steps at the plain version's positions: the
    penalty hinges keep it (max.NaN), as torch.maximum does."""
    args = _al_inputs(fleets, 130, mode, seed=6, dev=dev, rts_only=False,
                      stable=True)
    isb = args[7][:, 8] > 0.5
    rows = [int(torch.nonzero(~isb)[0]), int(torch.nonzero(isb)[0])]
    at = 3 if field == "usage" else 4
    args[at] = args[at].clone()
    args[at][rows, 7] = float("nan")
    got, want = (f(*args, mode=mode, k_steps=k_steps)[0]
                 for f in (al_step_cuda, al_step_ref))
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert nan[rows[1]].any()
    if field == "usage":
        assert nan[rows[0]].any()
    _close(torch.where(nan, 0.0, got), torch.where(nan, 0.0, want), 1e-5)


@pytest.mark.parametrize("field", ["usage", "jobs"])
def test_dr_features_keeps_a_nan_in_usage_or_jobs_as_its_plain_version(
        dev, field):
    d, u, j = _feature_rows(130, 9, dev)
    t = {"usage": u, "jobs": j}[field].clone()
    t[[3, 70], [5, 40]] = float("nan")
    args = (d, t, j) if field == "usage" else (d, u, t)
    got, want = dr_features_cuda(*args), dr_features_ref(*args)
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert nan[3, 0] and nan[70, 0] and nan[3, 3] and not nan[3, 1]
    _close(torch.where(nan, 0.0, got), torch.where(nan, 0.0, want), 2e-4)


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(6, 40), (2, 300, 2560)])
def test_rmsnorm_autograd_function_matches_plain_autograd(dev, dtype, tol,
                                                          shape):
    from repro_torch.kernels.rmsnorm.ops import RMSNormFn
    g = torch.Generator(device=dev).manual_seed(shape[-1])
    x = (1.5 * torch.randn(shape, generator=g, device=dev)).to(dtype)
    s = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    x.requires_grad_(True)
    s.requires_grad_(True)
    y = RMSNormFn.apply(x, s, 1e-6)
    assert torch.equal(y, rmsnorm_cuda(x.detach().reshape(-1, shape[-1]),
                                       s.detach()).reshape(shape))
    got = torch.autograd.grad(y, (x, s), dy)
    want = torch.autograd.grad(rmsnorm_ref(x, s), (x, s), dy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _rel_l2(a, b) < tol


FA_GRAD_CASES = [
    # (B, Sq, Skv, H, KV, Dh, Dv, causal, q_offset)
    (2, 1100, 1100, 8, 2, 64, 64, True, 0),
    (1, 256, 1300, 4, 4, 80, 80, False, 0),
    (1, 64, 1100, 4, 2, 64, 32, True, 1036),
    (2, 512, 512, 32, 32, 80, 80, True, 0),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FA_GRAD_CASES, ids=str)
def test_flash_attention_autograd_function_matches_plain_autograd(
        dev, dtype, tol, case):
    from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    B, Sq, Skv, H, KV, Dh, Dv, causal, qo = case
    g = torch.Generator(device=dev).manual_seed(Sq)
    q = torch.randn((B, Sq, H, Dh), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Skv, KV, Dh), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Skv, KV, Dv), generator=g, device=dev).to(dtype)
    do = torch.randn((B, Sq, H, Dv), generator=g, device=dev).to(dtype)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, q_offset=qo,
                                    with_lse=True)
    # The log-sum-exp buffer changes no bit of the forward.
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=causal,
                                                 q_offset=qo))
    _close(lse, attention_lse_ref(q, k, causal, qo), 1e-4)
    for t in (q, k, v):
        t.requires_grad_(True)
    y = FlashAttentionFn.apply(q, k, v, causal, qo)
    assert torch.equal(y, out)
    got = torch.autograd.grad(y, (q, k, v), do)
    want = torch.autograd.grad(attention_ref(q, k, v, causal=causal,
                                             q_offset=qo), (q, k, v), do)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _rel_l2(a, b) < tol


def test_full_width_train_step_loss_kernels_vs_plain(dev):
    """One train step of stablelm-3b at full width and 2 layers (batch 1
    x 512, remat on): the loss through the kernels within 1e-3 of the
    plain path's, the launches 4L + 1 and 2L, the updated parameters
    finite."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map
    cfg = dataclasses.replace(get_config("stablelm-3b"), num_layers=2)
    masters = tf.init_params(cfg, seed=0, device=dev)
    batch = synthetic_batch(cfg, ShapeCell("t", 512, 1, "train"), 0)
    oc = AdamWConfig(total_steps=2)
    losses = {}
    for kern in (True, False):
        rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
        p = tree_map(torch.clone, masters)   # the step updates in place
        p, _, loss = make_train_step(cfg, oc, use_kernel=kern)(
            p, adamw_init(p, oc), batch)
        losses[kern] = float(loss)
        want = (9, 4) if kern else (0, 0)
        assert (rmsnorm_cuda.launches, flash_attention_cuda.launches) == want
        leaves = (p["embed"]["table"], p["blocks"]["l0"]["ffn"]["w_up"]["w"])
        assert all(torch.isfinite(t).all() for t in leaves)
    assert abs(losses[True] - losses[False]) < 1e-3 * abs(losses[False])


# ---------------------------------------------------------------------------
# The ssd_scan backward kernel and SSM training
# ---------------------------------------------------------------------------
def _plain_scan_grads(states, dec, h0, g_prev, g_last):
    return _load_chip_smoke().plain_scan_grads(torch, states, dec, h0,
                                               g_prev, g_last)


def _decay_close(got, want):
    """Relative L2 within 1e-6 (zeros where no gradient reaches a
    decay: one chunk, or the last without a gradient on h_last)."""
    return float((got - want).norm()) <= 1e-6 * float(want.norm())


@pytest.mark.parametrize("case", range(12))
def test_ssd_scan_bwd_kernel_is_autograd_through_the_plain_version(dev,
                                                                   case):
    """chip_smoke.py's SSD_BWD_CASES (phase 8d's train shapes, then the
    forward's cases, a scalar P·N among them), with and without h0 and a
    gradient on h_last: dstates and dh0 bitwise, ddecay within 1e-6
    relative L2, one launch a call."""
    cases = _load_chip_smoke().SSD_BWD_CASES
    assert len(cases) == 12
    dims = cases[case]
    states, dec = _scan_inputs(dims, 20 + case, dev)
    g = torch.Generator(device=dev).manual_seed(case)
    h0 = torch.randn((dims[0],) + dims[2:], generator=g, device=dev)
    g_prev = torch.randn(dims, generator=g, device=dev)
    g_last = torch.randn((dims[0],) + dims[2:], generator=g, device=dev)
    for init in (None, h0):
        for last in (None, g_last):
            h_prev, want = _plain_scan_grads(states, dec, init, g_prev, last)
            before = ssd_scan_bwd_cuda.launches
            got = ssd_scan_bwd_cuda(g_prev, last, dec, h_prev,
                                    init is not None)
            assert ssd_scan_bwd_cuda.launches == before + 1
            assert torch.equal(got[0], want[0])
            assert _decay_close(got[1], want[1])
            if init is None:
                assert got[2] is None
            else:
                assert torch.equal(got[2], want[2])
            # The plain backward gives the same dstates and dh0.
            ref = ssd_scan_bwd_ref(g_prev, last, dec, h_prev,
                                   init is not None)
            assert torch.equal(ref[0], got[0])
            assert init is None or torch.equal(ref[2], got[2])


def test_ssd_scan_bwd_kernel_without_chunk_gradients_unaligned_and_bad(dev):
    """g_prev None (read as zeros); a g_prev view 4 bytes off a 16-byte
    boundary (the scalar kernel); operands the kernel refuses."""
    dims = (2, 3, 4, 8, 16)
    states, dec = _scan_inputs(dims, 31, dev)
    g_last = torch.randn((2, 4, 8, 16), device=dev)
    h_prev, want = _plain_scan_grads(states, dec, None, torch.zeros_like(
        states), g_last)
    got = ssd_scan_bwd_cuda(None, g_last, dec, h_prev, False)
    assert torch.equal(got[0], want[0]) and _decay_close(got[1], want[1])
    flat = torch.randn(states.numel() + 1, device=dev)
    off = flat[1:].view(dims)
    _, want = _plain_scan_grads(states, dec, None, off, None)
    got = ssd_scan_bwd_cuda(off, None, dec, h_prev, False)
    assert torch.equal(got[0], want[0]) and _decay_close(got[1], want[1])
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan_bwd_cuda(off.bfloat16(), None, dec, h_prev, False)
    with pytest.raises(ValueError, match="shape"):
        ssd_scan_bwd_cuda(None, g_last[:1].contiguous(), dec, h_prev, False)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_bwd_cuda(torch.randn((2, 3, 4, 16, 8), device=dev)
                          .transpose(3, 4), None, dec, h_prev, False)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd_cuda(None, None, dec.cpu(), h_prev.cpu(), False)


def test_ssd_scan_fn_through_ssd_chunked_matches_plain_autograd(dev):
    """`SSDScanFn` inside `ssd_chunked` at jamba's heads (128 of (64, 64),
    chunk 256, 3 chunks) and an initial state: every input's gradient
    within 1e-5 of autograd's through the plain version (the products
    around the scan are the same torch ops on both paths), one forward
    and one backward launch."""
    from repro_torch.models import ssm
    g = torch.Generator(device=dev).manual_seed(5)
    Bz, Sz, H, P, N, Q = 1, 768, 128, 64, 64, 256
    shapes = ((Bz, Sz, H, P), (Bz, Sz, H), (H,), (Bz, Sz, 1, N),
              (Bz, Sz, 1, N), (Bz, H, P, N))
    arrays = [torch.randn(s, generator=g, device=dev) for s in shapes]
    arrays[1] = 0.01 + 0.02 * arrays[1].abs()
    arrays[2] = -arrays[2].abs().exp()
    dy = torch.randn(shapes[0], generator=g, device=dev)
    dh = torch.randn(shapes[5], generator=g, device=dev)
    grads = []
    for kern in (None, False):
        f0, b0 = ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches
        inputs = [a.clone().requires_grad_(True) for a in arrays]
        y, h_last = ssm.ssd_chunked(*inputs[:5], Q, h0=inputs[5],
                                    use_kernel=kern)
        grads.append(torch.autograd.grad((y, h_last), inputs, (dy, dh)))
        n = 1 if kern is None else 0
        assert (ssd_scan_cuda.launches - f0,
                ssd_scan_bwd_cuda.launches - b0) == (n, n)
    for name, a, b in zip(("xh", "dt", "A", "Bm", "Cm", "h0"), *grads):
        assert _rel_l2(a, b) < 1e-5, name


def test_full_width_mamba2_gradients_kernels_vs_plain(dev):
    """mamba2-780m at full width and 2 layers, batch 1 x 1024 (4 chunks),
    remat on: the loss through the kernels within 1e-3 of the plain
    path's and each gradient leaf within 0.05 relative L2 (chip_smoke's
    8a bounds), the launches 4L + 1 rmsnorm, 2L ssd_scan and L backward."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.steps import make_loss_fn, value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import tree_items
    cfg = dataclasses.replace(get_config("mamba2-780m"), num_layers=2)
    assert cfg.remat
    masters = tf.init_params(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in synthetic_batch(
        cfg, ShapeCell("t", 1024, 1, "train"), 0).items()}
    out = {}
    for kern in (None, False):
        counts = (rmsnorm_cuda, ssd_scan_cuda, ssd_scan_bwd_cuda)
        before = [f.launches for f in counts]
        loss, grads = value_and_grad(make_loss_fn(cfg, use_kernel=kern),
                                     masters, batch)
        got = tuple(f.launches - b for f, b in zip(counts, before))
        assert got == ((9, 4, 2) if kern is None else (0, 0, 0))
        out[kern] = (float(loss), dict(tree_items(grads)))
    (lk, gk), (lp, gp) = out[None], out[False]
    assert np.isfinite(lk) and abs(lk - lp) < 1e-3 * abs(lp)
    for key in gp:
        assert _rel_l2(gk[key], gp[key]) < 0.05, key



# ---------------------------------------------------------------------------
# Fleet row sharding on torch.distributed (a world-1 NCCL group)
# ---------------------------------------------------------------------------
@pytest.fixture()
def nccl_world1(dev, tmp_path):
    """A one-process NCCL group on the card (rendezvous through a
    `FileStore`), destroyed after the test."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_sharded_world1_nccl_matches_unsharded(nccl_world1, fleets, policy):
    """CR1(1.45) and CR2(0.78) at W = 10,001 over a world-1 NCCL mesh
    through the kernels: within 0.01 pp of the unsharded solve (the JAX
    package's sharded bound), the same al_step and dr_features launches
    (75 and 1; 300 and 8), D of (W, T) and the state of (W, T)."""
    from repro_torch.core.api import CR1, CR2, SolveContext, solve
    from repro_torch.core.daygraph import COUNTED
    from repro_torch.core.fleet_solver import synthetic_fleet
    from repro_torch.launch.mesh import make_fleet_mesh
    p = synthetic_fleet(10_001, hours=T, seed=3,
                        templates=fleets["templates"])
    pol = CR1(lam=1.45) if policy == "cr1" else CR2(cap_frac=0.78)
    want_launches = ({"al_step": 75, "dr_features": 1} if policy == "cr1"
                     else {"al_step": 300, "dr_features": 8})
    out = {}
    for mesh in (None, make_fleet_mesh()):
        for f in COUNTED.values():
            f.launches = 0
        out[mesh is None] = solve(p, pol, ctx=SolveContext(mesh=mesh))
        assert {n: f.launches for n, f in COUNTED.items()} == want_launches
    got, want = out[False], out[True]
    assert got.D.shape == (10_001, T) and tuple(got.state.x.shape) == (
        10_001, T)
    assert abs(got.carbon_reduction_pct - want.carbon_reduction_pct) < 0.01
    assert abs(got.total_penalty_pct - want.total_penalty_pct) < 0.01
    assert got.preservation_violation < 1e-3


def test_sharded_solve_refuses_a_mesh_on_another_device_type(nccl_world1,
                                                              fleets):
    """A mesh made for the CPU does not run a solve on the card."""
    from repro_torch.core.api import CR1, SolveContext, solve
    from repro_torch.launch.mesh import make_fleet_mesh
    mesh = make_fleet_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="'cpu' devices but the solve"):
        solve(fleets[130], CR1(), ctx=SolveContext(mesh=mesh, steps=8))


def _counts():
    from repro_torch.core.daygraph import COUNTED
    return {n: f.launches for n, f in COUNTED.items()}


def _counted(call):
    """`call()` with the kernels' launch counts reset just before and read
    just after: (its result, the launches)."""
    from repro_torch.core.daygraph import COUNTED
    for f in COUNTED.values():
        f.launches = 0
    return call(), _counts()


def test_sharded_world1_nccl_day_captures_and_replays(nccl_world1, fleets):
    """A 24-tick CR1 day (cold 40 / warm 10) at W = 10,000 over a world-1
    NCCL mesh: a graph of its own, captured on the first day and replayed
    on the second; both days bitwise the unsharded day (committed, D,
    state) and a replay's launches the unsharded replay's."""
    from repro_torch.core.api import CR1, SolveContext, solve_day
    from repro_torch.core.carbon import ForecastStream
    from repro_torch.core.daygraph import DAY_GRAPHS
    from repro_torch.launch.mesh import make_fleet_mesh
    p = fleets[10_000]
    stream = ForecastStream.caiso(n_ticks=24, horizon=T, seed=5,
                                  revision_sigma=0.03)
    stack = np.stack([stream.forecast(t) for t in range(24)])
    budget = dict(cold_steps=40, warm_steps=10)
    out = {}
    for mesh in (None, make_fleet_mesh()):
        ctx = SolveContext(mesh=mesh)
        n0 = DAY_GRAPHS.captures
        first = solve_day(p, CR1(lam=1.45), stack, ctx=ctx, **budget)
        assert DAY_GRAPHS.captures == n0 + 1
        again, launches = _counted(lambda: solve_day(
            p, CR1(lam=1.45), stack, ctx=ctx, **budget))
        assert DAY_GRAPHS.captures == n0 + 1
        np.testing.assert_array_equal(first.committed, again.committed)
        out[mesh is None] = (again, launches)
    (got, got_n), (want, want_n) = out[False], out[True]
    assert got_n == want_n and got_n["al_step"] > 0
    np.testing.assert_array_equal(got.committed, want.committed)
    np.testing.assert_array_equal(got.last.D, want.last.D)
    for f in ("x", "lam_eq", "lam_in", "mu"):
        assert torch.equal(getattr(got.last.state, f),
                           getattr(want.last.state, f))


def test_sharded_world1_nccl_sweep_cr2(nccl_world1, fleets):
    """A CR2 sweep over cap_frac (0.74, 0.78), outer 2, 40 steps, at W =
    10,000 over a world-1 NCCL mesh: every lane bitwise the unsharded
    sweep's, at the same launches."""
    from repro_torch.core.api import CR2, SolveContext, sweep
    from repro_torch.launch.mesh import make_fleet_mesh
    pols = [CR2(cap_frac=c, outer=2) for c in (0.74, 0.78)]
    (want, want_n), (got, got_n) = (_counted(lambda m=m: sweep(
        fleets[10_000], pols, ctx=SolveContext(steps=40, mesh=m)))
        for m in (None, make_fleet_mesh()))
    assert got_n == want_n and got_n["al_step"] > 0
    for a, b in zip(got, want):
        assert a.state is None
        np.testing.assert_array_equal(a.D, b.D)
        assert a.carbon_reduction_pct == b.carbon_reduction_pct


def test_sharded_world1_nccl_ensemble_cr1(nccl_world1, fleets):
    """A CR1 ensemble of S = 8 (DuckPerturb 4, FleetJitter 2, FlexMixShift
    2; 40 steps) at W = 10,000 over a world-1 NCCL mesh: the batched lane,
    every scenario bitwise the unsharded ensemble's, at the same
    launches."""
    from repro_torch.core.api import CR1, SolveContext
    from repro_torch.core.ensemble import evaluate_ensemble
    from repro_torch.core.scenario import (DuckPerturb, FleetJitter,
                                           FlexMixShift)
    from repro_torch.launch.mesh import make_fleet_mesh
    scen = [DuckPerturb(4, seed=0), FleetJitter(2, seed=1),
            FlexMixShift(2, seed=2)]
    (want, want_n), (got, got_n) = (_counted(lambda m=m: evaluate_ensemble(
        fleets[10_000], CR1(lam=1.45), scen,
        ctx=SolveContext(steps=40, mesh=m)))
        for m in (None, make_fleet_mesh()))
    assert got.batched and want.batched
    assert got_n == want_n and got_n["al_step"] > 0
    np.testing.assert_array_equal(got.D, want.D)
    np.testing.assert_array_equal(got.penalties, want.penalties)


# ---------------------------------------------------------------------------
# The model mesh (training)
# ---------------------------------------------------------------------------
def test_model_mesh_world1_nccl_step_is_the_unsharded_step(nccl_world1):
    """Two sharded train steps of a reduced stablelm-3b (remat) over a
    world-1 NCCL mesh (`elastic.build`): the loss and every p, m and v
    leaf bitwise the unsharded `make_train_step`'s, at the same rmsnorm
    and flash-attention launches a step."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_items
    from repro_torch.runtime import elastic
    cfg = dataclasses.replace(reduced(get_config("stablelm-3b")), remat=True)
    oc = AdamWConfig(total_steps=10)
    p = tf.init_params(cfg, seed=1, device="cuda")
    o = adamw_init(p, oc)
    st = elastic.build(cfg, make_test_mesh(1, 1), p, o, oc)
    step = make_train_step(cfg, oc)
    for i in range(2):
        batch = synthetic_batch(cfg, ShapeCell("t", 64, 4, "train"), step=i)
        counts = []
        for run in (lambda: step(p, o, batch),
                    lambda: st.step_fn(st.params, st.opt_state, batch)):
            rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
            counts.append((run(), rmsnorm_cuda.launches,
                           flash_attention_cuda.launches))
        (p, o, want), *n_want = counts[0]
        (st.params, st.opt_state, got), *n_got = counts[1]
        assert got == want and n_got == n_want and n_got[0] > 0
    flat = dict(tree_items({"p": st.params, "m": st.opt_state["m"],
                            "v": st.opt_state["v"]}))
    for key, w in tree_items({"p": p, "m": o["m"], "v": o["v"]}):
        assert torch.equal(flat[key].to_local(), w), key


def test_model_mesh_compressed_psum_pod_on_cuda_over_two_gloo_ranks(dev):
    """`compressed_psum_pod` on CUDA tensors over the pod axis of a (pod 2,
    data 1, model 1) mesh of 2 gloo ranks on the card, on the reference
    test's case: error < 0.05, residual < 0.05, the ranks' sums equal."""
    import torch_model_mesh_worker as worker
    g = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)
    res = worker.Group(2, lambda tmp: [("c", dict(
        kind="compress", g=g, mesh=(1, 1, 2), device="cuda"))]).results()
    exact = (g[0] + g[1]) / 2
    for r in res:
        assert r["c"]["device"] == "cuda"
        assert float(np.abs(r["c"]["out"][0] - exact).max()) < 0.05
        assert float(np.abs(r["c"]["error"]).max()) < 0.05
    np.testing.assert_array_equal(res[0]["c"]["out"], res[1]["c"]["out"])
