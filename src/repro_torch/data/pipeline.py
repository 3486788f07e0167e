"""Data pipeline: deterministic synthetic token streams with host sharding
and background prefetch; the port of `repro/data/pipeline.py`.

The stream is seeded per (seed, step, host), with the reference's numpy
generator, so `synthetic_batch` gives the reference's bytes for the same
(seed, step, host) and every host materialises only its shard. Prefetch
runs on a background thread with a bounded queue. Batches stay numpy on
the host: the train step moves them to the parameters' device.

In the Carbon Responder fleet this pipeline is itself a batch workload:
`set_throttle` lets the DR schedule cut its throughput.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeCell


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    prefetch: int = 2


def synthetic_batch(cfg: ArchConfig, shape: ShapeCell, step: int,
                    dc: DataConfig = DataConfig()) -> dict[str, np.ndarray]:
    """One host-shard of a global batch: int32 tokens and labels (b, S),
    Zipf-distributed over the vocabulary; for the encdec family f32
    frames (b, encoder_seq, d); for the vlm family the text tail (b, S -
    Sv) of tokens and labels, f32 vision embeddings (b, Sv, d) and int32
    M-RoPE positions (3, b, S) that give t, h and w each token's index.
    The draws are the reference's, in its order."""
    assert shape.global_batch % dc.host_count == 0
    b = shape.global_batch // dc.host_count
    rng = np.random.default_rng((dc.seed, step, dc.host_index))
    S = shape.seq_len
    toks = rng.zipf(1.3, size=(b, S)).astype(np.int64)
    toks = np.clip(toks, 0, cfg.vocab_size - 1).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        sv = int(S * cfg.vision_tokens_frac)
        batch["tokens"] = batch["tokens"][:, :S - sv]
        batch["labels"] = batch["labels"][:, :S - sv]
        batch["vision_embeds"] = rng.standard_normal(
            (b, sv, cfg.d_model)).astype(np.float32)
        batch["mrope_positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, b, S)).copy()
    return batch


class PrefetchingLoader:
    """Background-thread loader with a bounded queue and a DR throttle.

    `set_throttle(frac)` scales effective throughput by delaying dequeues,
    the knob the FleetCoordinator drives from the CR schedule.
    """

    def __init__(self, cfg: ArchConfig, shape: ShapeCell,
                 dc: DataConfig = DataConfig(), start_step: int = 0):
        self.cfg, self.shape, self.dc = cfg, shape, dc
        self._q: queue.Queue = queue.Queue(maxsize=dc.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._throttle = 1.0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            batch = synthetic_batch(self.cfg, self.shape, self._step, self.dc)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def set_throttle(self, frac: float) -> None:
        self._throttle = max(0.05, min(1.0, frac))

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._throttle < 1.0:
            # DR enforcement: stretch inter-batch time by 1/throttle.
            time.sleep(0.01 * (1.0 / self._throttle - 1.0))
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
