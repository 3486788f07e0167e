"""DR-aware serving driver: batched decode with admission control.

The port of `repro/launch/serve.py`. A real-time (RTS) fleet workload:
requests arrive, are batched, prefilled once and decoded step by step.
Carbon Responder's power cap maps to an admission limit, `max_batch`; the
queueing delay that results is the QoS degradation the penalty curves
price. `ServeStats` reports latency percentiles.

Behaviour kept from the reference: the prefill is the cacheless
`forward`, and the cache is warmed by replaying the prompt through decode
steps, so a batch of prompts of S tokens with `max_new` new tokens runs
one forward and S + max_new - 1 decode steps. The port casts the weights
to the activation dtype once per batch (`greedy_decode`), where the
reference casts them at every use, and keeps the tokens on the
parameters' device until a batch ends.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 8
    arrival_s: float = 0.0
    done_s: float | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeStats:
    latencies_s: np.ndarray
    throughput_tok_s: float
    batch_size_used: int

    def p(self, q: float) -> float:
        return float(np.percentile(self.latencies_s, q))


def _device(params: dict) -> torch.device:
    return params["embed"]["table"].device


def greedy_decode(params, cfg: ArchConfig, prompts: np.ndarray,
                  max_new: int, max_len: int) -> np.ndarray:
    """Batched prefill + greedy decode on the parameters' device.
    prompts: (B, S) -> (B, max_new) int32 tokens."""
    params = tf.compute_params(params, cfg)
    dev = _device(params)
    B, S = prompts.shape
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=dev)
    logits = tf.forward(params, cfg, {"tokens": toks})
    next_tok = torch.argmax(logits[:, -1], dim=-1)
    cache = tf.init_cache(cfg, B, max_len, device=dev)
    # Warm the cache by replaying the prompt through decode steps (simple,
    # correct; a production system would fill the cache from prefill).
    for t in range(S):
        _, cache = tf.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
    out = [next_tok]
    for i in range(max_new - 1):
        logits, cache = tf.decode_step(params, cfg, cache, out[-1][:, None],
                                       S + i)
        out.append(torch.argmax(logits[:, -1], dim=-1))
    return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


def serve_requests(params, cfg: ArchConfig, requests: Sequence[Request],
                   max_batch: int, max_len: int = 128) -> ServeStats:
    """Admission-controlled batched serving. `max_batch` is the power knob:
    CR power caps shrink it, queueing delay rises, QoS degrades."""
    t0 = time.time()
    pending = list(requests)
    total_tokens = 0
    while pending:
        batch = pending[:max_batch]
        pending = pending[max_batch:]
        prompts = np.stack([r.prompt for r in batch])
        toks = greedy_decode(params, cfg, prompts,
                             max_new=batch[0].max_new, max_len=max_len)
        now = time.time()
        for r, row in zip(batch, toks):
            r.tokens = row.tolist()
            r.done_s = now
        total_tokens += toks.size
    lat = np.asarray([r.done_s - t0 + r.arrival_s for r in requests])
    return ServeStats(latencies_s=lat,
                      throughput_tok_s=total_tokens / max(time.time() - t0,
                                                          1e-9),
                      batch_size_used=max_batch)
