"""Carry the JAX package's objects into the port, as numpy arrays.

Duck-typed: each function takes the fields of the reference's object
(arrays, or anything `np.asarray` reads) and never imports that package.
Typical use, with `p` a reference `FleetProblem`:

    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    problem = fleet_problem_from_arrays(**fields)

and, with `tree` the reference's `transformer.init_params` or
`encdec.init_params` output mapped through `np.asarray`:

    params = transformer_params_from_arrays(tree, device="cpu")
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.core.engine import EngineState
from repro_torch.core.fleet_solver import (DATA_FIELDS, FleetProblem,
                                           RegionTopology)
from repro_torch.core.penalty import PenaltyModel
from repro_torch.kernels.dispatch import resolve_device


def fleet_problem_from_arrays(*, topology=None, **fields) -> FleetProblem:
    """A port `FleetProblem` from the reference's data and meta fields; a
    migration `topology` (the reference's, or anything with its cost,
    bandwidth, ceiling and labels) becomes the port's `RegionTopology`."""
    if topology is not None:
        ceil = topology.ceiling
        fields["topology"] = RegionTopology(
            cost=np.asarray(topology.cost, float).copy(),
            bandwidth=np.asarray(topology.bandwidth, float).copy(),
            ceiling=None if ceil is None else np.asarray(ceil, float).copy(),
            labels=None if topology.labels is None
            else tuple(topology.labels))
    for name in DATA_FIELDS:
        if fields.get(name) is not None:
            fields[name] = np.asarray(fields[name]).copy()
    names = fields.get("names")
    if names is not None:
        fields["names"] = tuple(names)
    return FleetProblem(**fields)


def penalty_model_from_arrays(*, name, kind, usage, entitlement, k, params,
                              jobs=None, slo_hours=4,
                              feature_names=None) -> PenaltyModel:
    """A port `PenaltyModel` from the reference model's fields."""
    return PenaltyModel(
        name=str(name), kind=str(kind), usage=np.asarray(usage).copy(),
        entitlement=float(entitlement), k=float(k),
        params=tuple(float(a) for a in params),
        jobs=None if jobs is None else np.asarray(jobs).copy(),
        slo_hours=int(slo_hours),
        feature_names=None if feature_names is None
        else tuple(feature_names))


def engine_state_from_arrays(x, lam_eq, lam_in, mu,
                             device: str | torch.device) -> EngineState:
    """A warm-start `EngineState` (float32 tensors on `device`)."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return EngineState(x=t(x), lam_eq=t(lam_eq), lam_in=t(lam_in), mu=t(mu))


# The parameter trees of the ported models, decoder-only
# (`repro.models.transformer`: dense, moe, vlm, SSM and hybrid, GQA or
# MLA) and encoder-decoder (`repro.models.encdec`): the keys each level
# may hold (`blocks` holds a group's positions `l0` ... `l{G-1}`, which
# the hybrid's mix: `attn` or `ssm`, `ffn` or `moe`; `unembed` only where
# the embeddings are untied, `b` where the model has qkv biases, `q_norm`
# / `k_norm` with qk-norm; under `moe` the stacked experts are arrays and
# `shared` only where the model has shared experts; MLA's `q_norm` is
# over the query latent; `mtp`, DeepSeek-V3's multi-token-prediction
# head, holds its projection, two norms and one layer with no leading
# group axis, whose keys are a group position's). `_node` names a group
# position `l{j}`.
_PARAM_KEYS = {
    "": {"embed", "blocks", "ln_f", "unembed", "mtp",
         "enc_blocks", "enc_ln", "dec_blocks", "dec_ln"},
    "mtp": {"proj", "ln_h", "ln_e", "layer"},
    "embed": {"table"}, "unembed": {"table"}, "blocks": {"l{j}"},
    **{pos: {"ln1", "attn", "ln2", "ffn", "moe", "ssm"}
       for pos in ("l{j}", "layer")},
    "enc_blocks": {"ln1", "attn", "ln2", "ffn"},
    "dec_blocks": {"ln1", "attn", "lnx", "xattn", "ln2", "ffn"},
    "attn": {"wq", "wk", "wv", "wo", "q_norm", "k_norm",
             "wdq", "wuq", "wdkv", "kv_norm", "wkr", "wuk", "wuv"},
    "xattn": {"wq", "wk", "wv", "wo"},
    "wq": {"w", "b"}, "wk": {"w", "b"}, "wv": {"w", "b"}, "wo": {"w"},
    "ffn": {"w_gate", "w_up", "w_down"},
    "moe": {"router", "w_gate", "w_up", "w_down", "shared"},
    "shared": {"w_gate", "w_up", "w_down"},
    **{w: {"w"} for w in ("router", "wdq", "wuq", "wdkv", "wkr", "wuk",
                          "wuv")},
    "w_gate": {"w"}, "w_up": {"w"}, "w_down": {"w"},
    "ssm": {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
            "out_proj"},
    "in_proj": {"w"}, "out_proj": {"w"}, "proj": {"w"},
    **{norm: {"scale"} for norm in ("ln_f", "ln1", "ln2", "lnx", "enc_ln",
                                    "dec_ln", "norm", "q_norm", "k_norm",
                                    "kv_norm", "ln_h", "ln_e")},
}


def _node(key: str) -> str:
    """The `_PARAM_KEYS` entry of a key: `l{j}` for a group position."""
    return "l{j}" if re.fullmatch(r"l\d+", key) else key


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes, which torch cannot read
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def transformer_params_from_arrays(tree: dict, device=None) -> dict:
    """The port's parameters (same tree, same dtypes, on `device`, the
    card by default) from the reference's `init_params` tree of either
    model module: `transformer` (dense, moe, vlm, SSM, hybrid) or
    `encdec`."""
    dev = resolve_device(device)

    def walk(node, name):
        extra = {k for k in node if _node(k) not in _PARAM_KEYS.get(name,
                                                                    set())}
        if extra:
            raise NotImplementedError(
                f"parameters {sorted(extra)} under {name or 'the root'!r} "
                "belong to a model path the port does not have")
        return {k: walk(v, _node(k)) if isinstance(v, dict)
                else _to_tensor(v, dev) for k, v in node.items()}

    return walk(tree, "")


def adamw_state_from_arrays(state: dict, device=None) -> dict:
    """The port's AdamW state ({m, v, step}: moment trees in their dtypes,
    step an int32 scalar, on `device`, the card by default) from the
    reference's `adamw_init`/`adamw_update` state."""
    dev = resolve_device(device)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else _to_tensor(v, dev)
                for k, v in node.items()}

    return {"m": walk(state["m"]), "v": walk(state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}
