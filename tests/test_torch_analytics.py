"""The port's analytic FLOP and byte model (`repro_torch.launch.analytics`)
against the JAX package's (`repro.launch.analytics`), on every registered
config at the reference's four shape cells (train_4k, prefill_32k,
decode_32k, long_500k), from shapes alone.

`forward_flops` and `cell_flops` are equal exactly, and so is
`cell_ici_bytes` wherever no parameter term enters it (every cell at one
chip, every tensor-parallel split, every cell but training). The
parameter terms read `params_read()`: the port's exact `param_count()`,
less deepseek's MTP head outside training, where the reference's count
is approximate (ROADMAP B6). The test computes the gap,
`params_read(cfg, shape) - jcfg.param_count()`, and holds
`cell_hbm_bytes`, `analytic_record` and the training cells'
`cell_ici_bytes` equal exactly to the reference's run on the port's
counts (the reference's `param_count` and `active_param_count` replaced
by a test-local monkeypatch; the record names the whole count), and
their differences from the reference's own numbers equal to what the
gap's bytes make, to 1e-12 relative (float sums in another order).
Tolerance: exact, but for that 1e-12.

Footprint: the reference is called through `repro.configs` and
`repro.launch.analytics`, which imports only `repro.configs.base` and
`repro.models.moe`; nothing is materialised (the `meta` device).
"""
import jax
import pytest

from repro.configs import get_config as j_get_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import ArchConfig as JArchConfig
from repro.launch import analytics as ja
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import analytics, steps

CHIPS = (1, 4)
SPLITS = ((1, 1), (4, 1), (1, 4), (2, 2))       # (data, model)
REL = 1e-12
CELLS = [(a, s.name) for a in ARCH_IDS for s in SHAPES]


def _pair(arch, shape):
    shapes = {s.name: s for s in SHAPES}
    jshapes = {s.name: s for s in J_SHAPES}
    return get_config(arch), j_get_config(arch), shapes[shape], \
        jshapes[shape]


def test_same_cells_and_configs_as_the_reference():
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    assert set(ARCH_IDS) == set(J_ARCH_IDS)
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.kind) for s in J_SHAPES]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_is_the_meta_tree(arch):
    """The count the byte model reads is exact: the numel of the model's
    tree on the `meta` device, and never below the reference's; the
    active count leaves out the routed experts a token skips and the MTP
    head (deepseek's), which only the training loss reads."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    mod = steps.model_module(cfg)
    params = mod.init_params(cfg, device="meta")
    n = sum(t.numel() for t in jax.tree.leaves(params))
    assert n == cfg.param_count() >= jcfg.param_count()
    moe_layers = sum(cfg.layer_kind(i)[1] == "moe"
                     for i in range(cfg.num_layers))
    if cfg.moe is not None:
        e = cfg.moe
        mtp = sum(t.numel() for t in jax.tree.leaves(params.get("mtp", {})))
        assert cfg.param_count() - cfg.active_param_count() == \
            moe_layers * (e.num_experts - e.top_k) * 3 * cfg.d_model \
            * e.d_expert_ff + mtp


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_match_jax(arch, shape):
    cfg, jcfg, s, js = _pair(arch, shape)
    f = analytics.forward_flops(cfg, s)
    assert f == ja.forward_flops(jcfg, js) and f > 0
    assert analytics.cell_flops(cfg, s) == ja.cell_flops(jcfg, js)
    if s.kind == "train":
        assert analytics.cell_flops(cfg, s) == 4 * f     # remat


def _gap_bytes(cfg, shape, gap):
    """Bytes a step that `gap` more parameters add to `cell_hbm_bytes`
    (before the division by chips)."""
    bpp = {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    if shape.kind == "train":
        passes = 3 + (1 if cfg.remat else 0)
        mom_bpp = 4 if cfg.param_dtype == "float32" else 2
        return gap * (passes * bpp + 6 * mom_bpp)
    return gap * bpp


def _ici_gap_bytes(cfg, shape, gap, data):
    if shape.kind != "train" or data == 1:
        return 0.0
    bpp = {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    passes = 3 if cfg.remat else 2
    return (passes + 1) * gap * bpp * (data - 1) / data


@pytest.mark.parametrize("arch,shape", CELLS)
def test_bytes_and_record_match_jax_up_to_the_count_gap(arch, shape,
                                                        monkeypatch):
    cfg, jcfg, s, js = _pair(arch, shape)
    n_read = analytics.params_read(cfg, s)
    gap = n_read - jcfg.param_count()
    assert gap >= 0
    own = {}
    for chips in CHIPS:
        got = analytics.cell_hbm_bytes(cfg, s, chips)
        want = ja.cell_hbm_bytes(jcfg, js, chips)
        assert got - want == pytest.approx(
            _gap_bytes(cfg, s, gap) / chips, rel=REL, abs=1e-3)
        own[chips] = (got, analytics.analytic_record(cfg, s, chips))
    ici = {}
    for data, model in SPLITS:
        got = analytics.cell_ici_bytes(cfg, s, data, model)
        want = ja.cell_ici_bytes(jcfg, js, data, model)
        gap_b = _ici_gap_bytes(cfg, s, gap, data)
        if gap_b == 0.0:
            assert got == want
        else:
            assert got - want == pytest.approx(gap_b, rel=REL)
        ici[data, model] = got
        assert analytics.cell_ici_bytes(cfg, s, data, model,
                                        fsdp_weights=False, pods=2) >= 0
    # The reference on the port's exact counts: equal, every number (the
    # record names the whole count, the bytes read the cell's).
    n, n_active = cfg.param_count(), cfg.active_param_count()
    monkeypatch.setattr(JArchConfig, "param_count", lambda self: n_read)
    monkeypatch.setattr(JArchConfig, "active_param_count",
                        lambda self: n_active)
    for chips in CHIPS:
        got, record = own[chips]
        assert got == ja.cell_hbm_bytes(jcfg, js, chips)
        assert record == dict(ja.analytic_record(jcfg, js, chips),
                              param_count=n)
        assert record["param_count"] == n
        assert record["active_param_count"] == n_active
    for (data, model), got in ici.items():
        assert got == ja.cell_ici_bytes(jcfg, js, data, model)
        assert analytics.cell_ici_bytes(
            cfg, s, data, model, fsdp_weights=False, pods=2) == \
            ja.cell_ici_bytes(jcfg, js, data, model, fsdp_weights=False,
                              pods=2)


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
def test_only_training_reads_the_mtp_head(shape):
    """deepseek-v3's MTP head (only the training loss reads it) adds its
    bytes to a training cell's HBM and interconnect bytes and nothing to
    a prefill or decode cell's."""
    import dataclasses
    cfg = get_config("deepseek-v3-671b")
    bare = dataclasses.replace(cfg, mtp_depth=0)
    s = {c.name: c for c in SHAPES}[shape]
    head = cfg.mtp_param_count()
    assert cfg.mtp_depth and head > 0 and bare.mtp_param_count() == 0
    assert cfg.param_count() - bare.param_count() == head
    train = s.kind == "train"
    assert analytics.params_read(cfg, s) == \
        bare.param_count() + (head if train else 0)
    for chips in CHIPS:
        diff = analytics.cell_hbm_bytes(cfg, s, chips) \
            - analytics.cell_hbm_bytes(bare, s, chips)
        if train:
            assert diff == pytest.approx(_gap_bytes(cfg, s, head) / chips,
                                         rel=REL)
        else:
            assert diff == 0.0
    for data, model in SPLITS:
        diff = analytics.cell_ici_bytes(cfg, s, data, model) \
            - analytics.cell_ici_bytes(bare, s, data, model)
        assert diff == pytest.approx(_ici_gap_bytes(cfg, s, head, data),
                                     rel=REL, abs=1e-3)


def test_jamba_at_sixteen_layers_by_hand():
    """The model chip_smoke's phase 6e times: jamba at full width and 16
    layers, a 1 x 8192 prefill. Its FLOPs by hand from the layer kinds
    (14 Mamba-2 layers, 2 attention layers over a causal mean context
    of 4096, 8 MoE and 8 dense FFNs, the head) equal the model's."""
    import dataclasses
    from repro_torch.configs import ShapeCell
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=16)
    cell = ShapeCell("prefill_8k", 8192, 1, "prefill")
    d, f, V = 4096, 14336, 65536
    d_in, H, N, P, Q = 8192, 128, 64, 64, 256
    ssm_tok = (2 * d * (2 * d_in + 2 * N + H) + 2 * d_in * d
               + 2 * 4 * (d_in + 2 * N)
               + H * (2 * Q * N + 2 * Q * P + 4 * N * P))
    attn_tok = 2 * d * (32 + 16) * 128 + 2 * 32 * 128 * d \
        + 4 * 4096 * 32 * 128
    moe_tok = 2 * 6 * d * f + 2 * d * 16 + 4 * 16 * 40 * d   # C = 40
    dense_tok = 6 * d * f
    per_tok = 14 * ssm_tok + 2 * attn_tok + 8 * moe_tok + 8 * dense_tok \
        + 2 * d * V
    assert analytics.forward_flops(cfg, cell) == pytest.approx(
        per_tok * 8192, rel=REL)
