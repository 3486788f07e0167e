"""The model mesh's runtime on the CPU: elastic resize, the sharded
checkpoint and its resharding restore, the runner recovering onto a
mesh, int8 gradient compression over the pod axis, and the refusals, on
4 gloo ranks (`tests/torch_model_mesh_worker.py`), against the port's
unsharded step and the JAX package's functions.

* `elastic.build` on 2 x 2, a step, `resize` to 1 x 2 (ranks 2 and 3
  leave and hold `meta` trees), a step, `resize` back to 2 x 2, a step:
  params and moments bitwise across each resize
  (`tests/test_runtime.py:165-197`'s contract), the three losses within
  1e-5 relative of the unsharded step's and the state within
  `tests/test_torch_optim.py`'s 1e-4 / 1e-6;
* a sharded `save` on 2 x 2 (the reference's layout, one writer) and
  `restore(shardings=)` onto a (2, 1) mesh of ranks 0 and 1: bitwise,
  each leaf on its target placements, then a step there; ranks 2 and 3,
  outside that mesh, are refused by name;
* `FaultTolerantRunner` over the sharded step, a checkpoint every 2
  steps and a failure at step 3: the unsharded runner's events, losses
  (1e-5) and state (1e-4 / 1e-6), the state still DTensors;
* `compressed_psum_pod` on the reference test's case
  (`tests/test_runtime.py:130-160`: error < 0.05, residual < 0.05) and
  bitwise the same arithmetic composed from the reference's `_quantize`
  and `_dequantize`;
* refusals: `make_production_mesh` on 4 processes, `make_test_mesh` and
  `mesh_from_devices` whose product is not the ranks given, a DTensor
  handed to each kernel launcher.

Footprint: the JAX reference is called only through
`repro.runtime.compression`'s pure quantizers (jax.numpy alone).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_model_mesh_worker as worker
from repro.runtime.compression import _dequantize as j_dequantize
from repro.runtime.compression import _quantize as j_quantize
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.ft import FailurePlan, FaultTolerantRunner, FTConfig

CFG = reduced(get_config("stablelm-3b"))
OPT = adamw.AdamWConfig(total_steps=10)
TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
N_BATCHES = 8
G = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = tf.init_params(CFG, seed=3, device="cpu")
    batches = [synthetic_batch(CFG, ShapeCell("t", 16, 4, "train"), step=i)
               for i in range(N_BATCHES)]
    base = dict(cfg=CFG, params=_numpy(params),
                opt=_numpy(adamw.adamw_init(params, OPT)), opt_cfg=OPT)

    def jobs(tmp):
        return [("elastic", dict(base, kind="elastic", batches=batches[:3])),
                ("checkpoint", dict(base, kind="checkpoint",
                                    batches=batches[:2],
                                    dir=f"{tmp}/ckpt")),
                ("runner", dict(base, kind="runner", batches=batches, steps=5,
                                dir=f"{tmp}/runner")),
                ("compress", dict(kind="compress", g=G)),
                ("refusals", dict(kind="refusals"))]

    group = worker.Group(4, jobs)
    solo = []
    p = _clone(params)
    o = adamw.adamw_init(p, OPT)
    step = make_train_step(CFG, OPT)
    for b in batches[:3]:
        p, o, loss = step(p, o, b)
        solo.append((loss, worker._flat({"params": p, "m": o["m"],
                                         "v": o["v"]})))
        solo[-1] = (loss, {k: v.numpy().copy()
                           for k, v in solo[-1][1].items()})
    p = _clone(params)
    runner = FaultTolerantRunner(
        step, CheckpointManager(tmp_path_factory.mktemp("solo_runner")),
        FTConfig(checkpoint_every=2), FailurePlan(fail_steps=(3,)))
    rp, ro, rlosses = runner.run(p, adamw.adamw_init(p, OPT), iter(batches),
                                 num_steps=5)
    ranks = group.results()
    return dict(ranks=ranks, solo=solo, runner=dict(
        losses=rlosses, events=[e["event"] for e in runner.events],
        state={k: v.numpy() for k, v in worker._flat(
            {"params": rp, "m": ro["m"], "v": ro["v"]}).items()}))


def _close(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_elastic_resize_keeps_the_state_bitwise(runs):
    r = [x["elastic"] for x in runs["ranks"]]
    for rank, x in enumerate(r):
        assert x["member_small"] == (rank < 2)
        assert x["meta_small"] == (rank >= 2)
        assert x["member_big"]
        assert x["before"] == r[0]["before"]
        assert x["grown"] == r[0]["grown"]
    # 2 x 2 -> 1 x 2 and 1 x 2 -> 2 x 2 move no bit.
    assert r[0]["shrunk"] == r[0]["before"] == r[1]["shrunk"]
    assert r[0]["grown"] == r[0]["after_step"] == r[1]["after_step"]


def test_elastic_steps_match_the_unsharded_steps(runs):
    got = runs["ranks"][0]["elastic"]
    np.testing.assert_allclose(got["losses"], [s[0] for s in runs["solo"]],
                               rtol=LOSS_RTOL, atol=0)
    _close(got["state"], runs["solo"][2][1])
    for rank, x in enumerate(runs["ranks"]):    # 2 and 3 sit out step 2
        assert x["elastic"]["losses"] == (got["losses"] if rank < 2 else
                                          got["losses"][0::2])


def test_sharded_checkpoint_restores_onto_another_mesh_bitwise(runs):
    r = [x["checkpoint"] for x in runs["ranks"]]
    assert r[0]["files"] == ["step_00000001"]
    for x in r[:2]:
        assert x["step"] == 1
        assert all(x["placements"])
        assert x["restored"] == r[0]["saved"]
        assert x["after"] == r[0]["after"]
    np.testing.assert_allclose(r[0]["loss"], runs["solo"][1][0],
                               rtol=LOSS_RTOL, atol=0)
    _close(r[0]["state"], runs["solo"][1][1])


def test_restore_refuses_a_mesh_the_rank_is_not_in(runs):
    for rank in (2, 3):
        msg = runs["ranks"][rank]["checkpoint"]["refused"]
        assert msg is not None and "not in the mesh" in msg
        assert f"rank {rank}" in msg


def test_runner_recovers_onto_the_mesh(runs):
    want = runs["runner"]
    assert want["events"] == ["failure", "restored"]
    for x in runs["ranks"]:
        got = x["runner"]
        assert got["events"] == want["events"]
        assert got["sharded"]
        assert got["digest"] == runs["ranks"][0]["runner"]["digest"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL, atol=0)
    _close(runs["ranks"][0]["runner"]["state"], want["state"])


def test_compressed_psum_pod_within_the_reference_bounds(runs):
    exact = (G[0] + G[1]) / 2
    q = [j_quantize(jnp.asarray(G[p:p + 1])) for p in range(2)]
    qsum = np.asarray(q[0][0], np.int32) + np.asarray(q[1][0], np.int32)
    ssum = np.asarray(q[0][1]) + np.asarray(q[1][1])
    want_out = np.asarray(j_dequantize(jnp.asarray(qsum, jnp.float32) / 2,
                                       jnp.asarray(ssum) / 2, (1, 64),
                                       jnp.float32))
    for x in runs["ranks"]:
        got = x["compress"]
        p = got["pod"]
        assert float(np.abs(got["out"][0] - exact).max()) < 0.05
        assert float(np.abs(got["error"]).max()) < 0.05
        assert got["error_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(got["out"], want_out)
        approx = np.asarray(j_dequantize(q[p][0], q[p][1], (1, 64),
                                         jnp.float32))
        want_e = jnp.asarray(G[p:p + 1] - approx).astype(jnp.bfloat16)
        np.testing.assert_array_equal(got["error"],
                                      np.asarray(want_e, np.float32))
    assert sorted(x["compress"]["pod"] for x in runs["ranks"]) == [0, 0, 1, 1]


@pytest.mark.parametrize("key,kind,words", [
    ("production", "ValueError", "256 processes"),
    ("production_pod", "ValueError", "512 processes"),
    ("test_mesh", "ValueError", "the group has 4"),
    ("devices", "ValueError", "4 ranks were given"),
    ("rmsnorm", "TypeError", "rmsnorm_cuda takes plain tensors"),
    ("flash_attention", "TypeError", "flash_attention_cuda takes plain"),
    ("dr_features", "TypeError", "dr_features_cuda takes plain"),
    ("al_step", "TypeError", "al_step_cuda takes plain"),
    ("ssd_scan", "TypeError", "ssd_scan_cuda takes plain"),
    ("ssd_scan_bwd", "TypeError", "ssd_scan_bwd_cuda takes plain")])
def test_refusals(runs, key, kind, words):
    for x in runs["ranks"]:
        got = x["refusals"][key]
        assert got is not None and got[0] == kind and words in got[1], got
