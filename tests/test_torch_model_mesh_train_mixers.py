"""The sharded train step on a model mesh for the SSM, MoE, MLA and
hybrid families: `tests/test_torch_model_mesh_train.py`'s checks (world 1
bitwise the unsharded step; world 4 on 2 x 2 and (pod 2, data 1, model
2) meshes within its bounds; the JAX package's step) on the reduced
mamba2-780m, qwen3-moe-30b-a3b (capacity factor 8: no token dropped, so
splitting a batch over ranks keeps every token's experts),
deepseek-v3-671b with its MTP head, and jamba-v0.1-52b.

Footprint: as `tests/test_torch_model_mesh_train.py`'s.
"""
import pytest

from test_torch_model_mesh_train import (BATCHES, MESHES4, check_jax,
                                         check_world1, check_world4,
                                         make_runs)

CASES = ("mamba2", "qwen3_moe", "deepseek_mtp", "jamba")


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
