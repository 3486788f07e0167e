"""The sharded train step on a model mesh (`launch/steps.py`
`make_sharded_train_step` through `runtime/elastic.build`) on the CPU,
against the port's unsharded `make_train_step` and the JAX package's
step.

The ranks are gloo processes spawned once per world size for the whole
module (`tests/torch_model_mesh_worker.py`): world 1 (a 1 x 1 mesh) and
world 4 (a 2 x 2 (data, model) mesh and a (pod 2, data 1, model 2) one).
Cases here: the reduced stablelm-3b (and with remat, the only CPU check
of the gather inside the checkpoint), whisper-large-v3 and qwen2-vl-72b;
`test_torch_model_mesh_train_mixers.py` runs the same checks on
mamba2-780m, qwen3-moe-30b-a3b, deepseek-v3-671b with its MTP head and
jamba-v0.1-52b. Two steps on global batches of 4 rows (a dp shard's 2
rows split over "model") and of 2 (the "model" ranks compute the same
row).

Bounds: at world 1 the loss and every p, m and v leaf bitwise the
unsharded step's; at world 4 the loss within 1e-5 relative and params
and moments at `tests/test_torch_optim.py`'s rtol 1e-4 / atol 1e-6
after 2 steps under its `AdamWConfig(total_steps=10)` (ROADMAP A12), the
steps themselves (p after - p before) at its 1e-2 / 1e-7; the ranks'
gathered states bitwise each other; each rank's state bytes the rules'
count. Against the JAX step (composed as `tests/test_torch_optim.py:117`
composes it) the loss, params and moments at the same bounds (the steps
themselves part by an ulp of the parameter where Adam divides by a tiny
gradient, as the port's own unsharded step does from JAX's).

Footprint: the JAX reference is called only through `repro.models` and
`repro.optim.adamw`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_model_mesh_worker as worker
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import encdec as j_encdec
from repro.models import transformer as j_tf
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw

ALL_CASES = {"stablelm": ("stablelm-3b", {}),
             "stablelm_remat": ("stablelm-3b", {"remat": True}),
             "whisper": ("whisper-large-v3", {}),
             "qwen2_vl": ("qwen2-vl-72b", {}),
             "mamba2": ("mamba2-780m", {}),
             "qwen3_moe": ("qwen3-moe-30b-a3b", {}),
             "deepseek_mtp": ("deepseek-v3-671b", {}),
             "jamba": ("jamba-v0.1-52b", {})}
# The dense and encoder-decoder cases here; the SSM, MoE, MLA and hybrid
# ones in test_torch_model_mesh_train_mixers.py (each file under a minute).
CASES = ("stablelm", "stablelm_remat", "whisper", "qwen2_vl")
BATCHES = {"split": 4, "same_rows": 2}
MESHES4 = {"2x2": (2, 2, 1), "pod2x1x2": (1, 2, 2)}
SEQ = 16
STEPS = 2
OPT = adamw.AdamWConfig(total_steps=10)
JOPT = j_adamw.AdamWConfig(total_steps=10)
LOSS_RTOL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-2, atol=1e-7)


def _configs(arch, change):
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **change),
            dataclasses.replace(reduced(get_config(arch)), **change))


def _draw(jcfg, seed):
    """numpy draws in the JAX tree's shapes: weights N(0, 1/fan_in), tables
    N(0, 0.02²), norm scales and D 1 + N(0, 0.1²), A_log and dt_bias near
    a decay of 0.95 a step, small vectors N(0, 0.1²)."""
    mod = j_encdec if jcfg.family == "encdec" else j_tf
    shapes = jax.eval_shape(lambda: mod.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
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
        elif len(s.shape) < 2:
            out = 0.1 * z
        else:
            out = z / np.sqrt(s.shape[-2])
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _case(name, seed):
    arch, change = ALL_CASES[name]
    jcfg, cfg = _configs(arch, change)
    arrays = _draw(jcfg, seed)
    params = transformer_params_from_arrays(arrays, device="cpu")
    batches = {kind: [synthetic_batch(cfg, ShapeCell("t", SEQ, B, "train"),
                                      step=i) for i in range(STEPS)]
               for kind, B in BATCHES.items()}
    return dict(jcfg=jcfg, cfg=cfg, arrays=arrays, params=params,
                batches=batches)


def _jobs(cases, world):
    def jobs(_tmp):
        out = []
        for name, c in cases.items():
            for kind in BATCHES:
                meshes = MESHES4 if world == 4 else {"1x1": (1, 1, 1)}
                for mname, shape in meshes.items():
                    out.append((f"{name}/{kind}/{mname}", dict(
                        kind="train", cfg=c["cfg"], mesh=shape,
                        params=_numpy(c["params"]),
                        opt=_numpy(adamw.adamw_init(c["params"], OPT)),
                        opt_cfg=OPT, batches=c["batches"][kind])))
        return out
    return jobs


def _unsharded(c, kind):
    p = _clone(c["params"])
    o = adamw.adamw_init(p, OPT)
    step = make_train_step(c["cfg"], OPT)
    losses = []
    for batch in c["batches"][kind]:
        p, o, loss = step(p, o, batch)
        losses.append(loss)
    return dict(losses=losses, state={
        k: v.numpy() for k, v in worker._flat({"params": p, "m": o["m"],
                                               "v": o["v"]}).items()})


def _jax(c):
    jcfg = c["jcfg"]
    mod = j_encdec if jcfg.family == "encdec" else j_tf

    @jax.jit
    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: mod.loss_fn(p, jcfg, batch))(params)
        updates, opt = j_adamw.adamw_update(grads, opt, params, JOPT)
        return j_adamw.apply_updates(params, updates), opt, loss

    jp = jax.tree.map(jnp.asarray, c["arrays"])
    jo = j_adamw.adamw_init(jp, JOPT)
    losses = []
    for batch in c["batches"]["split"]:
        jp, jo, loss = step(jp, jo, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        losses.append(float(loss))
    tree = {"params": jp, "m": jo["m"], "v": jo["v"]}
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat[".".join(str(getattr(k, "key", k)) for k in path)] = \
            np.asarray(leaf)
    return dict(losses=losses, state=flat)


def make_runs(names):
    """Both groups' results, the unsharded steps' and the JAX steps' for
    the cases `names` (the parent steps while the ranks run)."""
    cases = {name: _case(name, list(ALL_CASES).index(name))
             for name in names}
    groups = {w: worker.Group(w, _jobs(cases, w)) for w in (1, 4)}
    solo = {f"{name}/{kind}": _unsharded(c, kind)
            for name, c in cases.items() for kind in BATCHES}
    jaxed = {name: _jax(c) for name, c in cases.items()}
    ranks = {w: g.results() for w, g in groups.items()}
    start = {name: {k: v.numpy() for k, v in worker._flat(
        {"params": c["params"]}).items()} for name, c in cases.items()}
    return dict(solo=solo, jax=jaxed, ranks=ranks, start=start)


def check_world1(runs, case, kind):
    """At world 1 the sharded step is the unsharded one bit for bit."""
    got = runs["ranks"][1][0][f"{case}/{kind}/1x1"]
    want = runs["solo"][f"{case}/{kind}"]
    assert got["losses"] == want["losses"]
    assert sorted(got["state"]) == sorted(want["state"])
    for key, w in want["state"].items():
        np.testing.assert_array_equal(got["state"][key], w, err_msg=key)
    assert got["step"] == STEPS
    assert got["bytes"] == got["rule_bytes"]


def _close(got, want, start=None):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
        if start is not None and key in start:
            np.testing.assert_allclose(got[key] - start[key],
                                       want[key] - start[key], **STEP_TOL,
                                       err_msg=key)


def check_world4(runs, case, kind, mesh):
    """On 4 ranks: the unsharded step's loss and state within the bounds,
    the ranks bitwise each other, each rank's bytes the rules'."""
    ranks = [r[f"{case}/{kind}/{mesh}"] for r in runs["ranks"][4]]
    want = runs["solo"][f"{case}/{kind}"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        assert r["losses"] == ranks[0]["losses"]
        assert r["digest"] == ranks[0]["digest"]
        assert r["bytes"] == r["rule_bytes"]
        assert r["step"] == STEPS
    _close(ranks[0]["state"], want["state"], runs["start"][case])


def check_jax(runs, case):
    """The 2 x 2 sharded step against the JAX package's step."""
    got = runs["ranks"][4][0][f"{case}/split/2x2"]
    want = runs["jax"][case]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    _close(got["state"], want["state"])


@pytest.fixture(scope="module")
def runs():
    return make_runs(CASES)


@pytest.mark.parametrize("kind", list(BATCHES))
@pytest.mark.parametrize("case", CASES)
def test_world1_sharded_step_is_the_unsharded_step_bitwise(runs, case, kind):
    check_world1(runs, case, kind)


@pytest.mark.parametrize("mesh", list(MESHES4))
@pytest.mark.parametrize("kind", list(BATCHES))
@pytest.mark.parametrize("case", CASES)
def test_world4_sharded_step_matches_the_unsharded_step(runs, case, kind,
                                                        mesh):
    check_world4(runs, case, kind, mesh)


@pytest.mark.parametrize("case", CASES)
def test_world4_sharded_step_matches_jax(runs, case):
    check_jax(runs, case)
