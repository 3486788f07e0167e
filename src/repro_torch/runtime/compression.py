"""Cross-pod gradient compression with error feedback: the port of
`repro/runtime/compression.py`.

Across pods, the baseline all-reduces f32/bf16 gradients over the slower
inter-pod links. This module all-reduces them as int8 blocks with error
feedback (the residual carried to the next step), cutting cross-pod
bytes ~4x (bf16) / ~8x (f32).

The reference runs inside `shard_map` with "pod" a manual axis; the port
takes this rank's tensors and the pod axis of a model mesh
(`launch/mesh.py`, `make_test_mesh(pod=2)` or the multi-pod production
mesh): the int8 values are summed in int32 and the scales summed beside
them over the ranks that share every other coordinate. Rounding is half
to even in both packages (`torch.round`, `jnp.round`), so `_quantize`
and `_dequantize` are the reference's bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 256


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8. Returns (q: int8, scale: f32 per block)."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, dtype
                ) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def compressed_psum_pod(grads: dict, error: dict, mesh, axis: str = "pod",
                        ) -> tuple[dict, dict]:
    """All-reduce `grads` (this rank's tensors, a nested dict) over the
    `axis` dim of `mesh` in int8 with error feedback. Returns (the mean
    over the axis, the new error residuals in `error`'s dtypes).
    Collective over the axis's ranks."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def one(g, e):
        target = g.to(torch.float32) + e.to(torch.float32)
        q, scale = _quantize(target)
        # int8 values summed in int32; scales reduced alongside.
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, group=group)
        ssum = scale.clone()
        dist.all_reduce(ssum, group=group)   # conservative shared scale
        approx_local = _dequantize(q, scale, g.shape, torch.float32)
        new_e = (target - approx_local).to(e.dtype)
        # Dequantize the sum with the mean scale (all pods used similar
        # magnitudes; error feedback absorbs the mismatch).
        out = _dequantize(qsum.to(torch.float32) / n, ssum / n, g.shape,
                          g.dtype)
        return out, new_e

    def walk(gt, et):
        outs, errs = {}, {}
        for k in sorted(gt):
            if isinstance(gt[k], dict):
                outs[k], errs[k] = walk(gt[k], et[k])
            else:
                outs[k], errs[k] = one(gt[k], et[k])
        return outs, errs

    return walk(grads, error)


def init_error(params: dict) -> dict:
    """bf16 zeros in the shapes of `params` (on their devices)."""
    return {k: init_error(v) if isinstance(v, dict)
            else torch.zeros(v.shape, dtype=torch.bfloat16, device=v.device)
            for k, v in params.items()}
