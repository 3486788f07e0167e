"""Training the port's hybrid family against the JAX package's, on the
CPU: the reduced jamba-v0.1-52b of `test_torch_hybrid.py` at 8 and 16
layers (one and two block groups: Mamba-2 and attention mixers, dense
and MoE FFNs) through the checks `test_torch_ssm_train.py` runs on
mamba2: `loss_fn` and every gradient leaf against `jax.value_and_grad`
of the reference's `loss_fn` (1e-5; 1e-4 at 16 layers, `DEEP_TOL`),
remat on against off bitwise (a group is one checkpoint), three
`make_train_step` steps against a JAX step composed from `loss_fn` and
`repro.optim.adamw` at 8 layers, and the kernel calls of a remat train
step through `SSDScanFn` at 16 layers: 2(L + L_ffn + L_ssm) + 1
norms, ssd_scan's forward 2 L_ssm and its backward L_ssm times.

Footprint: as `test_torch_ssm_train.py`.
"""
import pytest

from test_torch_ssm_train import (build, check_loss_and_gradients,
                                  check_remat_bitwise,
                                  check_three_train_steps,
                                  check_train_step_kernel_calls)
from test_torch_ssm_train import plain_kernels  # noqa: F401 (a fixture)


@pytest.mark.parametrize("name", ["jamba8", "jamba16"])
def test_jamba_loss_and_every_gradient_leaf_match_jax(name):
    check_loss_and_gradients(build(name))


@pytest.mark.parametrize("name", ["jamba8", "jamba16"])
def test_jamba_remat_on_and_off_are_bitwise(name):
    check_remat_bitwise(build(name))


def test_jamba_three_train_steps_match_jax():
    check_three_train_steps(build("jamba8"))


def test_jamba_train_step_kernel_calls(plain_kernels,  # noqa: F811
                                       monkeypatch):
    """16 layers: 14 Mamba-2 mixers, 2 attention, an FFN in every layer:
    2(16 + 16 + 14) + 1 = 93 norms, 28 scans forward, 14 backward."""
    L, norms = check_train_step_kernel_calls(build("jamba16"),
                                             plain_kernels, monkeypatch)
    assert (L, norms) == (16, 93)
