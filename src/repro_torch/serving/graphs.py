"""The engine's compiled decode step (counterpart of the JAX engine's
``jax.jit(model.decode_step, donate_argnums=(1,))``, one per ladder rung).

:class:`DecodeGraph` wraps one model view's ``decode_step`` for one engine
cache.  Its first call warms the step up on a side stream, captures one
step as a CUDA graph over the live cache and replays it; every later call
copies the tokens into the graph's static buffer and replays.  A replay
launches the step's kernels from one host call, so the card no longer
waits on Python between them.

Warming up and capturing on the live state is safe because a decode step
is idempotent for given ``(cache["seq_len"], tokens)`` and recurrent
states: it rewrites the same KV, ring-buffer and tail-store rows and
advances ``seq_len``, and it updates the recurrent states of an RG-LRU or
RWKV layer (``models.transformer.CARRIED``) from their own values; the
wrapper restores the lengths and those states after each warm-up step.  The graph reads its tokens from a
static ``[max_batch]`` int64 device buffer and its lengths from
``cache["seq_len"]``; every other cache tensor is read and written at the
address it had at capture.  So a graph is bound to one cache dict, to the
tensors it held at capture and to which of the engine's planted outputs it
carried (``"_telemetry"``; tiered KV memory's ``"_sel_pages"`` and
``"_pre_pages"``), and a call that breaks any of these raises instead of
replaying over stale pointers.  Tiered memory moves page bytes in place on
those tensors between replays, so a graph keeps reading what it must.  A
capture that fails raises too: nothing falls back to the eager step.

A replay runs no Python, so it counts no kernel launches by itself: the
graph keeps the counts its captured step made (warm-up and capture leave
:func:`repro_torch.kernels.counts` as they found it) and adds them on every
replay.

:func:`step_graphs_disabled` (the counterpart of ``jax.disable_jit()``)
makes engines built inside it hand out the eager step.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.models.transformer import CARRIED

_disabled = 0


@contextlib.contextmanager
def step_graphs_disabled():
    """Engines built inside this context run their decode step eagerly."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def step_graphs_enabled() -> bool:
    return _disabled == 0


def graph_device(device: torch.device) -> bool:
    """Whether a decode step on ``device`` can be captured (CUDA only)."""
    return device.type == "cuda"


def new_pool():
    """A memory pool for the graphs of one engine (its rungs never run at
    once, so they may share one)."""
    return torch.cuda.graph_pool_handle()


#: device -> the one side stream of every warm-up and capture on it: cuBLAS
#: keeps a workspace for each stream it has run on, so a new stream per
#: graph would leave one workspace behind per graph
_side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device):
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device=device)
    return _side_streams[device]


def _on_side_stream(fn: Callable[[], None], device: torch.device):
    side = _side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)


def _capture(fn: Callable[[], torch.Tensor], pool, device: torch.device):
    """Capture ``fn()`` on ``device``'s side stream -> (graph, its output
    tensor).  The garbage collector is off during the capture (``torch.cuda
    .graph`` collects just before it): a collection there could destroy
    another graph or free device memory, CUDA calls that invalidate a
    capture in progress."""
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=_side_stream(device)):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    return graph, out


def _delta(after: Dict, before: Dict) -> Dict:
    return {n: {k: after[n][k] - before[n][k] for k in after[n]} for n in after}


#: the step's optional outputs, planted in the cache by the engine: the
#: sparsity counters and tiered KV memory's page masks
_PLANTED = ("_telemetry", "_sel_pages", "_pre_pages")


def _tensors(cache) -> Tuple:
    """Every tensor of ``cache`` the step may read or write, by identity:
    ``seq_len``, the planted outputs (None where absent), the layers'."""
    out = [cache["seq_len"]] + [cache.get(k) for k in _PLANTED]
    for e in cache["layers"]:
        out.extend(e.values())
    return tuple(out)


class DecodeGraph:
    """``step`` (a model view's ``decode_step``) captured over ``cache`` as
    one CUDA graph.  Called as the step is: ``(cache, tokens) -> (logits
    [B, vocab], cache)``; the logits are the graph's static output,
    overwritten by the next replay of any graph of the same pool, so a
    caller copies what it keeps.  ``replays`` counts the replays and
    ``step_counts`` holds the kernel counts of the captured step (as
    :func:`repro_torch.kernels.counts` gives them), added on each replay."""

    def __init__(self, step: Callable, cache, pool=None):
        device = cache["seq_len"].device
        if not graph_device(device):
            raise RuntimeError(
                f"a decode step on {device} cannot be captured as a CUDA graph")
        self._step = step
        self._cache = cache
        self._tensors = _tensors(cache)
        self._pool = pool
        self._tokens = torch.zeros(cache["seq_len"].shape, dtype=torch.int64,
                                   device=device)
        self._graph = None
        self._logits: Optional[torch.Tensor] = None
        self.step_counts: Optional[Dict] = None
        self.replays = 0

    def _check(self, cache):
        if cache is not self._cache:
            raise RuntimeError("this decode graph was captured over another cache")
        for i, key in enumerate(_PLANTED, 1):
            if (key in cache) != (self._tensors[i] is not None):
                raise RuntimeError(f"{key} was planted or removed after the capture")
        now = _tensors(cache)
        if len(now) != len(self._tensors) or any(
                a is not b for a, b in zip(now, self._tensors)):
            raise RuntimeError("a cache tensor was replaced after the capture")

    def __call__(self, cache, tokens):
        self._check(cache)
        self._tokens.copy_(torch.as_tensor(tokens).reshape(self._tokens.shape))
        if self._graph is None:
            self._build()
        self._graph.replay()
        kernels.add_counts(self.step_counts)
        self.replays += 1
        return self._logits, cache

    def _build(self):
        """Two eager steps on a side stream, each from the given lengths and
        recurrent states, then one captured step; the lengths, the states
        and the kernel counts are left as they were."""
        cache, seq_len = self._cache, self._cache["seq_len"]
        carried = [t for e in cache["layers"] for name, t in e.items()
                   if name in CARRIED]
        kept = [seq_len.clone()] + [t.clone() for t in carried]
        before = kernels.counts()

        def restore():
            for t, k in zip([seq_len] + carried, kept):
                t.copy_(k)

        def warm_up():
            for _ in range(2):
                restore()
                self._step(cache, self._tokens)
            restore()

        _on_side_stream(warm_up, seq_len.device)
        start = kernels.counts()
        graph, logits = _capture(lambda: self._step(cache, self._tokens)[0],
                                 self._pool, seq_len.device)
        self.step_counts = _delta(kernels.counts(), start)
        kernels.reset_counts()
        kernels.add_counts(before)
        restore()
        self._graph, self._logits = graph, logits
