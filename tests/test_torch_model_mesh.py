"""The model mesh's partition rules against the JAX package's, on shapes
alone (no processes, no parameters materialised).

* `legalize(param_specs(...))` of every `ARCH_IDS` config at full size
  (the port's tree on `meta`, the reference's through `jax.eval_shape`)
  leaf by leaf equal to the reference's, under `ShardingPolicy()` and
  each single knob flipped, on mesh-likes of (16, 16), (2, 16, 16) and
  (2, 2); each rank's bytes by the rules (`rule_bytes`) equal to the
  reference's count from its specs;
* `batch_specs`, `cache_specs` (batch divisible by the dp axes or not),
  `logits_spec`, `shape_by_name` and `input_specs` (shapes and dtypes,
  decode caches from `init_cache` on `meta`) equal to the reference's;
* `to_placements` and `to_named`, the axis order on a tensor dim shared
  by two mesh axes, `local_slice`;
* `_quantize` / `_dequantize` bitwise the reference's;
* the refusals that need no process group: a model mesh without one,
  `make_step_bundle` for prefill and decode cells and `lower_cell`
  (ROADMAP 11b-ii); a train bundle's shapes and placements.

Footprint: the reference's `repro.launch.sharding` pure functions and
`repro.launch.mesh.dp_axes` run on mesh-like objects (`.shape`,
`.axis_names`), as `tests/test_sharding.py:48` calls them; no JAX mesh
is made.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.configs.base import shape_by_name as j_shape_by_name
from repro.launch import sharding as jsh
from repro.launch.mesh import dp_axes as j_dp_axes
from repro.models import encdec as j_encdec
from repro.models import transformer as j_tf
from repro.runtime.compression import _dequantize as j_dequantize
from repro.runtime.compression import _quantize as j_quantize
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.configs.base import shape_by_name
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.runtime.dtensor import local_slice
from repro_torch.runtime.compression import _dequantize, _quantize


class MeshLike:
    """A mesh's axis names and sizes, for both packages' pure functions."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))

    def __repr__(self):
        return f"MeshLike{tuple(self.shape.values())}"


MESHES = {"16x16": MeshLike(("data", "model"), (16, 16)),
          "2x16x16": MeshLike(("pod", "data", "model"), (2, 16, 16)),
          "2x2": MeshLike(("data", "model"), (2, 2))}
POLICIES = {"default": sh.ShardingPolicy(),
            "no_fsdp_embed": sh.ShardingPolicy(fsdp_embed=False),
            "no_fsdp_weights": sh.ShardingPolicy(fsdp_weights=False),
            "fsdp_pod": sh.ShardingPolicy(fsdp_pod=True),
            "seq_shard_prefill": sh.ShardingPolicy(seq_shard_prefill=True),
            "expert_axis_data": sh.ShardingPolicy(expert_axis="data"),
            "no_ssm_tp": sh.ShardingPolicy(ssm_tp=False)}
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int32": torch.int32, "int8": torch.int8}


def _flat_jax(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out[".".join(str(getattr(k, "key", k)) for k in path)] = leaf
    return out


def _flat(tree, prefix="") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference ShapeDtypeStruct tree, port meta tree) at full size."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    mod = j_encdec if jcfg.family == "encdec" else j_tf
    jshape = jax.eval_shape(lambda: mod.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    return jshape, steps.params_shape_of(cfg)


def _same_tree(jtree, ttree):
    jf, tf_ = _flat_jax(jtree), _flat(ttree)
    assert sorted(jf) == sorted(tf_)
    return jf, tf_


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, policy, mesh):
    jshape, tshape = _shapes(arch)
    m, pol = MESHES[mesh], POLICIES[policy]
    jpol = jsh.ShardingPolicy(**dataclasses.asdict(pol))
    want = jsh.legalize(jshape, jsh.param_specs(jshape, jpol), m)
    got = sh.legalize(tshape, sh.param_specs(tshape, pol), m)
    jf, tf_ = _same_tree(want, got)
    jl, tl = _flat_jax(jshape), _flat(tshape)
    for key in jf:
        assert tuple(tl[key].shape) == tuple(jl[key].shape), key
        assert tl[key].dtype == _DT[str(jl[key].dtype)], key
        assert tf_[key] == tuple(jf[key]), key
    # Each rank's bytes by the rules, the reference's specs counted alike.
    want_bytes = 0
    for key, spec in jf.items():
        div = 1
        for axis in spec:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None:
                    div *= m.shape[a]
        want_bytes += int(np.prod(jl[key].shape)) * jl[key].dtype.itemsize \
            // div
    assert sh.rule_bytes(tshape, got, m) == want_bytes


def _spec_tuples(tree):
    return {k: tuple(v) for k, v in _flat_jax(tree).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_cache_logits_and_input_specs_match_reference(arch, mesh):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    m = MESHES[mesh]
    assert tmesh.dp_axes(m) == j_dp_axes(m)
    assert tmesh.has_pod_axis(m) == ("pod" in m.axis_names)
    for cell in SHAPES:
        assert shape_by_name(cell.name) == cell
        assert dataclasses.astuple(j_shape_by_name(cell.name)) == \
            dataclasses.astuple(cell)
        jspec, tspec = j_input_specs(jcfg, cell.name), input_specs(cfg, cell)
        jl, tl = _same_tree(jspec, tspec)
        for key in jl:
            assert tuple(tl[key].shape) == tuple(jl[key].shape), key
            assert tl[key].dtype == _DT[str(jl[key].dtype)], key
            assert tl[key].device.type == "meta"
        if cell.kind == "decode":
            for batch in (cell.global_batch, 3):   # divisible, not
                jc = jax.eval_shape(lambda: (j_encdec if jcfg.family ==
                                             "encdec" else j_tf).init_cache(
                    jcfg, batch, 64))
                tc = (steps.model_module(cfg)).init_cache(cfg, batch, 64,
                                                          device="meta")
                want = jsh.legalize(jc, jsh.cache_specs(jc, m, batch), m)
                got = sh.legalize(tc, sh.cache_specs(tc, m, batch), m)
                jw, tg = _same_tree(want, got)
                assert {k: tuple(v) for k, v in jw.items()} == tg
        else:
            want = jsh.batch_specs(jspec, m)
            got = sh.batch_specs(tspec, m)
            assert _spec_tuples(want) == _flat(got)
            want = jsh.legalize(jspec, want, m)
            assert _spec_tuples(want) == _flat(sh.legalize(tspec, got, m))
        for batch in (cell.global_batch, 3, 1):
            assert sh.logits_spec(m, batch, cfg.vocab_size) == tuple(
                jsh.logits_spec(m, batch, jcfg.vocab_size))


def test_shape_by_name_refuses_unknown():
    with pytest.raises(KeyError):
        shape_by_name("train_8k")


def test_legalize_drops_nondivisible_and_absent_axes():
    shapes = {"t": torch.empty((50281, 64), device="meta"),
              "u": torch.empty((64, 64), device="meta")}
    specs = {"t": ("model", "data"), "u": (("data", "pod"), None)}
    m = MESHES["16x16"]
    out = sh.legalize(shapes, specs, m)
    assert out == {"t": (None, "data"), "u": ("data", None)}
    assert out == {k: tuple(v) for k, v in jsh.legalize(
        {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
         for k, v in shapes.items()},
        {"t": jax.sharding.PartitionSpec("model", "data"),
         "u": jax.sharding.PartitionSpec(("data", "pod"), None)},
        m).items()}


def test_to_placements_and_named():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    assert sh.to_placements((None, "data", "model"), m) == (
        Replicate(), Shard(1), Shard(2))
    assert sh.to_placements((("data", "pod"), None), m) == (
        Shard(0), Shard(0), Replicate())
    assert sh.to_placements((), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="lacks"):
        sh.to_placements(("fleet",), m)
    with pytest.raises(ValueError, match="two tensor dims"):
        sh.to_placements(("data", "data"), m)
    named = sh.to_named({"a": {"b": ("model", None)}}, m)
    assert named["a"]["b"] == sh.NamedPlacement(
        m, (Replicate(), Replicate(), Shard(0)))


class _Coord:
    """A mesh-like with a rank's coordinate, for `local_slice`."""

    def __init__(self, shape, coord):
        self.mesh = torch.empty(shape, device="meta")
        self._coord = coord

    def get_coordinate(self):
        return self._coord


def test_axis_order_on_a_shared_dim():
    """A dim over two mesh axes is tiled in the mesh's order (DTensor's):
    ("data", "pod") on a (pod, data, model) mesh puts block pod·D + data
    on rank (pod, data), where the reference's row-major order over the
    spec's axes puts block data·P + pod; every rank holds one block of
    the same size either way."""
    from torch.distributed.tensor import Shard
    P_, D_ = 2, 3
    full = torch.arange(P_ * D_ * 4).reshape(P_ * D_ * 4, 1)
    pl = sh.to_placements((("data", "pod"), None),
                          MeshLike(("pod", "data", "model"), (P_, D_, 1)))
    assert pl[:2] == (Shard(0), Shard(0))
    for p in range(P_):
        for d in range(D_):
            got = local_slice(full, pl, _Coord((P_, D_, 1), (p, d, 0)))
            block = p * D_ + d
            assert torch.equal(got[:, 0], torch.arange(block * 4,
                                                       block * 4 + 4))
            assert got.shape == (4, 1)
    # ("data", "model") on a (data, model) mesh: the reference's order.
    pl = sh.to_placements((("data", "model"),), MeshLike(("data", "model"),
                                                         (2, 2)))
    flat = torch.arange(8)
    for d in range(2):
        for mm in range(2):
            got = local_slice(flat, pl, _Coord((2, 2), (d, mm)))
            assert torch.equal(got, flat[(d * 2 + mm) * 2:
                                         (d * 2 + mm) * 2 + 2])
    with pytest.raises(ValueError, match="does not divide"):
        local_slice(torch.arange(7), pl, _Coord((2, 2), (0, 0)))


@pytest.mark.parametrize("n", [7, 255, 256, 1000, 4096 + 17])
def test_quantize_dequantize_bitwise_reference(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32) * 3.0
    if n >= 256:
        x[:256] = 0.0                          # an all-zero block
    x[-1] = 127.0                              # scale 1: ties at .5 below
    x[-5:-1] = (-2.5, -1.5, 0.5, 2.5)
    q, scale = _quantize(torch.from_numpy(x))
    jq, jscale = j_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        back = _dequantize(q, scale, (n,), dtype)
        jback = j_dequantize(jq, jscale, (n,), jdtype)
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(jback.astype(jnp.float32)))


def test_model_meshes_need_a_group():
    for make in (lambda: tmesh.make_production_mesh(device_type="cpu"),
                 lambda: tmesh.make_test_mesh(1, 1, device_type="cpu")):
        with pytest.raises(RuntimeError, match="process group"):
            make()


@pytest.mark.parametrize("cell", ["prefill_32k", "decode_32k", "long_500k"])
def test_step_bundle_serving_cells_wait_for_11b_ii(cell):
    cfg = get_config("stablelm-3b")
    with pytest.raises(NotImplementedError, match="11b-ii"):
        steps.make_step_bundle(cfg, cell, MESHES["16x16"])
    with pytest.raises(NotImplementedError, match="11b-ii"):
        steps.lower_cell(cfg, cell, MESHES["16x16"])


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-32b",
                                  "whisper-large-v3"])
def test_train_bundle_shapes_and_placements(arch):
    """A train cell's bundle on a mesh-like: the reference's argument
    shapes and dtypes (bf16 params take bf16 moments), placements from the
    legalized rules, the state donated."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    m = MESHES["2x16x16"]
    b = steps.make_step_bundle(cfg, "train_4k", m)
    params, opt, batch = b.args_shape
    pspecs = sh.legalize(params, sh.param_specs(params), m)
    psh = sh.to_named(pspecs, m)
    assert b.in_shardings[0] == psh == b.out_shardings[0]
    assert b.in_shardings[1]["m"] == psh == b.in_shardings[1]["v"]
    assert b.donate_argnums == (0, 1)
    mdtype = torch.bfloat16 if cfg.param_dtype == "bfloat16" \
        else torch.float32
    for key, leaf in _flat(opt["m"]).items():
        assert leaf.dtype == mdtype and leaf.device.type == "meta", key
    jb = j_input_specs(jcfg, "train_4k")
    want = _spec_tuples(jsh.batch_specs(jb, m))
    got = {k: sh.to_placements(s, m) for k, s in want.items()}
    assert {k: v.placements for k, v in _flat(b.in_shardings[2]).items()} \
        == got
    assert sorted(batch) == sorted(jb)
