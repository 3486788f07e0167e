"""A whole rolling-horizon day as one CUDA-graph replay.

The JAX package runs a day (`solve_day`) as one jitted `lax.scan`: one
dispatch. The port's counterpart is a CUDA graph. The first day of each
static configuration (`api._Day`: policy, shapes, step budgets, the
first tick's shift and mu reset, ...) runs the day's tick loop
(`api._day_impl`) once eagerly on a side stream, which builds the
kernels and creates the library handles, then captures it; every day
after that copies its data into the graph's static input buffers and
replays. The host then does no work per kernel: a CR2 day at W = 10,000
is some two thousand `al_step` launches that the host no longer issues
one by one.

A capture that fails raises: nothing falls back to the eager loop.

Launch counts. The kernel wrappers count where they launch, and during a
capture they run but launch nothing on the card. So the counts a capture
adds are taken back and kept with the graph, and every replay adds them
(`DayGraph.launches`).

Captures are counted in the module-level `CAPTURES` (every capture,
whatever cache made it), which `analysis.recompile_guard` reads: a day
of a configuration already seen must capture nothing.

A sanitized day (`SolveContext(sanitize=True)`) is a configuration of
its own: its function zeroes the sanitizer's flag at its start and
returns it as one more output, so every replay starts clean and
`solve_day` reads the flag once after the replay.

Memory. Each graph keeps a private memory pool that holds the day's
intermediates, so the cache keeps at most `MAX_GRAPHS` graphs and drops
the least recently replayed one. The replay's outputs are the graph's
static buffers: the next replay of the same graph overwrites them
(`SolveContext.donate` says whether a result may alias them).
"""
from __future__ import annotations

import collections
from typing import Callable, Hashable

import torch

from repro_torch.kernels.al_step.kernel import al_step_cuda
from repro_torch.kernels.dr_features.kernel import dr_features_cuda

Tensor = torch.Tensor

#: The kernel wrappers on a day's path, by name: each counts its launches.
COUNTED = {"al_step": al_step_cuda, "dr_features": dr_features_cuda}
#: Graphs kept at once: a policy's cold and warm day, for CR1 and CR2.
MAX_GRAPHS = 4
#: CUDA-graph captures made in this process (`analysis.recompile_guard`).
CAPTURES = 0


def _counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in COUNTED.items()}


class DayGraph:
    """One captured day: its static inputs, the graph, its static outputs
    and the kernel launches one replay makes.

    `fn(inputs) -> tuple of tensors` must be a pure function of the
    tensors in `inputs` (a dict), which become the static input buffers.
    """

    def __init__(self, fn: Callable[[dict[str, Tensor]], tuple],
                 inputs: dict[str, Tensor]):
        global CAPTURES
        self.inputs = inputs
        device = next(iter(inputs.values())).device
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side), torch.no_grad():
            fn(inputs)                 # warm-up: real launches, counted
        stream.wait_stream(side)
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph), torch.no_grad():
            self.outputs = fn(inputs)
        CAPTURES += 1
        after = _counts()
        self.launches = {k: after[k] - before[k] for k in COUNTED}
        for name, fn_ in COUNTED.items():     # a capture launches nothing
            fn_.launches = before[name]

    def replay(self, inputs: dict[str, Tensor]) -> tuple:
        """Copy `inputs` (the tensors of the same configuration: the
        caller validates their shapes) into the static buffers, replay on
        the current stream and return the static outputs."""
        for name, src in inputs.items():
            if src is not self.inputs[name]:
                self.inputs[name].copy_(src)
        self.graph.replay()
        for name, n in self.launches.items():
            COUNTED[name].launches += n
        return self.outputs


class DayGraphCache:
    """Captured days by static configuration, at most `MAX_GRAPHS` of
    them; `captures` counts the captures made."""

    def __init__(self):
        self.captures = 0
        self._graphs: collections.OrderedDict[Hashable, DayGraph] = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._graphs)

    def get(self, key: Hashable) -> DayGraph | None:
        return self._graphs.get(key)

    def run(self, key: Hashable, fn: Callable[[dict[str, Tensor]], tuple],
            inputs: dict[str, Tensor]) -> tuple:
        """Replay the graph of `key` on `inputs`, capturing `fn` first if
        there is none."""
        graph = self._graphs.get(key)
        if graph is None:
            graph = DayGraph(fn, inputs)
            self.captures += 1
            self._graphs[key] = graph
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        return graph.replay(inputs)


#: The graphs of `api.solve_day`, one per static day configuration.
DAY_GRAPHS = DayGraphCache()
