"""CUDA graphs of the greedy decoder's S = 1 step (`decode/greedy.py`).

One step of the eager greedy loop enqueues about 120 launches from
Python, and at a few decoder layers the host takes longer to enqueue them
than the card takes to run them. Here one step -- the decoder step at the
last token, its log-softmax, then the next token's choice and the rows'
bookkeeping -- is captured once as a CUDA graph and replayed. The
position lives on the device, a (B,) int32 tensor that the graph advances
itself, as the JAX loop's position is traced inside its `lax.while_loop`.

A graph reads and writes fixed addresses, so each key owns the buffers
its graphs were captured over (`StepState`): the self and cross caches,
the tokens, the next log-probabilities, the chosen token, the position,
the rows' done, length and sum_logp, and the suppression mask. A call
fills them in place (`init_cache(out=)`, the eager prompt step), so it
never reads what an earlier call left there. The key is what the step
observes (`greedy._graph_key`): the device, the batch, cache and cross
shapes and dtypes, the EOT id, the mask's shape, the config and the
decoder weights' addresses; never a position. A key holds one graph per
branch phase of the step (inside the suppression window or past it).

`StepGraphs` keeps at most `max_keys` states, and together at most
`MEMORY_SHARE` of the card's memory: before a new state is made, the
least recently used are evicted (their buffers freed to the allocator)
until it fits beside the rest, and a state larger than the share alone is
never held (its call runs eagerly). Every graph takes its temporaries
from one shared memory pool: the graphs keep nothing there between
replays, and they replay one at a time (`lock`) on the caller's stream. A
phase's first use runs the step eagerly on the capture stream (the step
itself, and the warm-up a capture needs), then captures it.

A replay runs the kernels without their Python wrappers, so the
wrappers' launch counters (`.launches` and the like, in `ops/kernels/`)
count their calls -- eager steps, and a capture's recording once -- and
not the replays, which `greedy_decode.graph_steps` counts. Holding `lock`
keeps the decodes of every thread eager.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional

import torch

from ..models.whisper import DecoderCache, _arr

# the held states' bound: at large-v2, B=128, one state (18 GB) of 80 GB
MEMORY_SHARE = 0.25


class StepState:
    """The buffers one key's graphs read and write, and the graphs by
    branch phase."""

    def __init__(self, cache: DecoderCache, b: int, ctx: int, n_vocab: int,
                 mask: Optional[torch.Tensor]):
        device = _arr(cache.cross_k).device

        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.cache = cache
        self.tokens = zeros(b, ctx)
        self.logp = zeros(b, n_vocab, dtype=torch.float32)
        self.mask = None if mask is None else mask.clone()
        self.tok = zeros(b)  # the last chosen token
        self.pos = zeros(b, dtype=torch.int32)  # where it was written
        self.done = zeros(b, dtype=torch.bool)
        self.all_done = zeros(dtype=torch.bool)
        self.length = zeros(b)
        self.sum_logp = zeros(b, dtype=torch.float32)
        self.graphs: Dict[Hashable, torch.cuda.CUDAGraph] = {}

    def nbytes(self) -> int:
        arrays = [t for c in self.cache
                  for t in ((c,) if isinstance(c, torch.Tensor) else c)]
        arrays += [t for t in vars(self).values()
                   if isinstance(t, torch.Tensor)]
        return sum(t.numel() * t.element_size() for t in arrays)


class StepGraphs:
    """The captured steps by key, least recently used first."""

    def __init__(self, max_keys: int = 8):
        self.max_keys = max_keys
        self.lock = threading.Lock()  # held by the one graphed decode
        self._states: "OrderedDict[Hashable, StepState]" = OrderedDict()
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def __len__(self) -> int:
        return len(self._states)

    def clear(self) -> None:
        with self.lock:
            self._states.clear()

    def get(self, key: Hashable) -> Optional[StepState]:
        state = self._states.get(key)
        if state is not None:
            self._states.move_to_end(key)
        return state

    @staticmethod
    def limit(device: torch.device) -> float:
        """The bytes the held states may take together on `device`."""
        if device.type != "cuda":
            return float("inf")
        return torch.cuda.get_device_properties(device).total_memory \
            * MEMORY_SHARE

    def add(self, key: Hashable, device: torch.device, nbytes: int,
            make: Callable[[], StepState]) -> Optional[StepState]:
        """A new key's state of about `nbytes`, made by `make()` once the
        least recently used keys are evicted down to the bounds; None,
        with nothing made or evicted, where it alone exceeds the share."""
        limit = self.limit(device)
        if nbytes > limit:
            return None
        held = sum(s.nbytes() for s in self._states.values())
        while self._states and (len(self._states) >= self.max_keys
                                or held + nbytes > limit):
            held -= self._states.popitem(last=False)[1].nbytes()
        state = self._states[key] = make()
        return state

    def _pool(self, device: torch.device):
        """The pool of the device's live graphs: a pool is freed with its
        last graph, and its handle is then void. A new one without any."""
        for state in self._states.values():
            if state.tokens.device == device and state.graphs:
                return next(iter(state.graphs.values())).pool()
        return torch.cuda.graph_pool_handle()

    def step(self, state: StepState, phase: Hashable,
             body: Callable[[], None]) -> str:
        """Run one step: replay the phase's graph ("replay"), or run `body`
        eagerly and capture it for the next time ("capture"); off the card,
        run it eagerly ("eager")."""
        device = state.tokens.device
        if device.type != "cuda":
            body()
            return "eager"
        graph = state.graphs.get(phase)
        if graph is not None:
            graph.replay()
            return "replay"
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        stream = self._streams[device]
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            body()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._pool(device),
                                capture_error_mode="thread_local")
            try:
                body()  # recorded, not run
            finally:
                graph.capture_end()
        caller.wait_stream(stream)
        state.graphs[phase] = graph
        return "capture"


# the greedy decoder's graphs, shared by every caller in the process
STEP_GRAPHS = StepGraphs()
