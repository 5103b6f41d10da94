"""The fixed-batch decode step as a CUDA graph: the port's counterpart of
the reference's one-jit decode horizon
(``xllm_service_tpu/engine/engine.py``, ``decode_multi``: a ``lax.scan``
of the step inside one donated ``jax.jit``).

The engine's step (``decode_forward``, ``sample_tokens``,
``record_tokens``, the device-side stop and budget update, the row pack)
reads and writes only tensors the engine allocates once and updates in
place, so one captured step replays on the live state: a horizon of H
steps is H replays, each followed by the copy of the step's row into the
horizon's buffer. A replay costs the host one launch instead of one per op
of every layer.

Variants are keyed by what the host already knows: whether any running
slot wants logprobs (the top-K pack), whether any samples (the per-slot
generators' draws) and, for the Sarathi mixed step (the first step of a
horizon that carries a prefill chunk, the reference's
``decode_chunk_multi``), the chunk's span, C or 4C rows. The mixed step
reads its chunk from buffers the engine writes in place before the replay
(tokens, the chunk's page row, its start and valid length), so a horizon
with a ride is one replay of a mixed variant and H - 1 of a plain one.
A speculative call is C replays of a spec-cycle variant, keyed ``("spec",
want_lp, sample)``, each followed by the copy of the cycle's row (the
reference's ``spec_multi``, a ``lax.scan`` of C cycles); the cycle reads
its budget from a room buffer the engine uploads before the call, and its
verify forward's logits come from the graph's private pool.
Capture is lazy. At a variant's first use a warm-up
step runs on the capture stream: it builds every kernel library, the
split-K work space and cuBLAS's work space on the stream the graph records
(so the graph holds pointers that outlive it) and fills rope's cache. The
warm-up is then undone: the state it advanced (``state``: last tokens,
lengths, active flags, the penalty histogram and, with speculation, the
token history and the room) is copied back and the
generators' states restored; its K/V writes need no undoing, since the
step writes the same rows at the same positions again. The step is
captured, and every step of the variant, the first included, is a replay
of that graph, kept for the engine's life. A sampling variant registers
the engine's per-slot generators, so each replay draws from each slot's
generator where an eager call would; a generator re-seeded between
replays starts its stream afresh.

Launch counts: the kernel wrappers count launches in Python (``.launches``),
which a replay does not run. The runner tallies the launches its own
thread counts while the step is captured (``ops/_build.py::launch_tally``:
another engine's thread counting meanwhile is not in it), takes them back
(capture executes nothing), and adds them again at every replay, so a
counter still says how many times its kernel ran (the warm-up's launches
included).

Captures are serialized across the process (``_CAPTURE_LOCK``): entering
a capture empties the caching allocator's cache, which must not happen
while another engine of the process (an agent's replica) is capturing.
Automatic garbage collection is off while a step records: collecting an
unreachable engine's graphs on the capturing thread is an operation the
capture mode forbids, and it invalidates the capture.

A capture that fails raises; nothing here falls back to the eager step.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable, Sequence

import torch

from ..ops import _build

# One capture at a time in the process (see the module docstring).
_CAPTURE_LOCK = threading.Lock()   # lock-order: 845


class DecodeGraphs:
    """Captured decode steps of one engine on one CUDA device.

    ``step(*key)`` runs one decode step in place on the engine's state,
    its arguments naming the variant (``(want_lp, sample)``, and the span
    for a mixed step; ``("spec", want_lp, sample)`` for a spec cycle);
    ``state`` are the tensors it advances (apart from
    the K/V pool); ``generators`` are the per-slot generators a sampling
    step draws from."""

    def __init__(self, step: Callable[..., None],
                 state: Sequence[torch.Tensor],
                 generators: Sequence[torch.Generator],
                 device: torch.device):
        self._step = step
        self._state = list(state)
        self._generators = list(generators)
        self.device = device
        self.stream = torch.cuda.Stream(device)
        # step arguments -> (graph, [(counter, launches per replay)])
        self._graphs: dict[tuple, tuple] = {}
        self.captures = 0
        self.replays = 0

    def run(self, *key) -> None:
        """One decode step with the step's arguments ``key``: a replay of
        the variant's graph, captured first at the variant's first use."""
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(key)
        graph, deltas = entry
        graph.replay()
        for fn, n in deltas:
            _build.count_launch(fn, n)
        self.replays += 1

    def _capture(self, key: tuple) -> tuple:
        """Warm up, undo the warm-up, capture; returns (graph, [(counter,
        launches per replay)]). A mixed step's warm-up writes its chunk's
        K/V as the replay will again."""
        with _CAPTURE_LOCK:
            return self._capture_locked(key)

    def _capture_locked(self, key: tuple) -> tuple:
        sample = key[2] if key[0] == "spec" else key[1]
        cur = torch.cuda.current_stream(self.device)
        s = self.stream
        gen_states = [g.get_state() for g in self._generators]
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            saved = [t.clone() for t in self._state]
            self._step(*key)                      # the warm-up
            for t, v in zip(self._state, saved):
                t.copy_(v)
        cur.wait_stream(s)
        for g, st in zip(self._generators, gen_states):
            g.set_state(st)
        graph = torch.cuda.CUDAGraph()
        if sample:
            for g in self._generators:
                graph.register_generator_state(g)
        # thread_local: the tier workers' copies and allocations, and other
        # engines' steps, on other threads stay legal while this engine's
        # thread captures.
        # No automatic garbage collection while the step records: it could
        # destroy an unreachable engine's graphs on this thread, which the
        # capture mode forbids, invalidating the capture.
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with _build.launch_tally() as counts, \
                    torch.cuda.graph(graph, stream=s,
                                     capture_error_mode="thread_local"):
                self._step(*key)
        finally:
            if gc_on:
                gc.enable()
        for fn, n in counts.items():
            _build.count_launch(fn, -n)
        self.captures += 1
        return graph, [(fn, n) for fn, n in counts.items() if n]
