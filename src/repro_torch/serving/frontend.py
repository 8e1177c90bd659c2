"""Continuous-batching async front-end over the serving :class:`Engine`
(counterpart of ``repro.serving.frontend``).

``Engine.run_until_done`` drains a fixed request list: everything must be
submitted up front and results only surface after the loop exits.  The
:class:`AsyncFrontend` turns the same tick loop into a continuously-batched
service:

- ``submit()`` accepts requests at any time — before the serve loop starts
  or mid-flight while other sequences are decoding.  Each call returns a
  :class:`TokenStream`, an async iterator that yields output tokens as the
  engine commits them.
- ``run()`` is the serve loop: it ticks the engine while there is work,
  pumps freshly committed tokens into the per-request streams, and parks on
  an event when idle (no busy spin between arrivals).
- ``shutdown()`` stops admission; ``run()`` returns once in-flight work has
  drained.  ``drain()`` awaits completion of everything accepted so far
  without closing the front door.

Token identity with the synchronous drain path is by construction: sampling
is keyed by ``(seq_id, position)`` (see ``serving.sampler.sample``), so
output tokens are invariant to arrival timing and batch composition — a
request streamed through this front-end yields exactly the tokens
``run_until_done`` would have produced.

Stream ordering survives checkpoint restore (``repro_torch.resilience``): a
restore truncates ``req.output`` to the checkpoint watermark and replay
regenerates the truncated suffix byte-identically, so the pump keeps a
**max** watermark per request and only emits beyond it — no token is ever
re-emitted or reordered, even when the engine rewinds underneath us.

Determinism for tests and benches: the loop never consults wall-clock time.
``on_tick(frontend, tick)`` fires synchronously after every engine tick, so
a scenario driver can submit at exact ticks; the only awaits are
``asyncio.sleep(0)`` (cooperative yield) and the idle event.
"""
from __future__ import annotations

import asyncio
from collections import deque
from typing import Callable, Dict, List, Optional

from repro_torch.serving.scheduler import Request

__all__ = ["AsyncFrontend", "TokenStream"]


class TokenStream:
    """Async iterator over one request's output tokens.

    Produced by :meth:`AsyncFrontend.submit`; consumed with
    ``async for tok in stream``.  Iteration ends when the request finishes
    (retired or failed — check :attr:`status` / :attr:`failed` after).
    """

    def __init__(self, req: Request):
        self.req = req
        self._buf: deque = deque()
        self._done = False
        self._event = asyncio.Event()

    # -- producer side (frontend pump) --------------------------------------

    def _push(self, tokens: List[int]):
        self._buf.extend(tokens)
        self._event.set()

    def _finish(self):
        self._done = True
        self._event.set()

    # -- consumer side -------------------------------------------------------

    @property
    def status(self) -> str:
        """``ok`` while streaming / on success, ``failed`` if the engine
        exhausted the request's failure budget."""
        return getattr(self.req, "status", "ok")

    @property
    def failed(self) -> bool:
        return self.status == "failed"

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        while True:
            if self._buf:
                return self._buf.popleft()
            if self._done:
                raise StopAsyncIteration
            self._event.clear()
            await self._event.wait()

    async def collect(self) -> List[int]:
        """Drain the stream to completion; -> all tokens in emit order."""
        return [tok async for tok in self]


class AsyncFrontend:
    """Continuous-batching serve loop over an :class:`Engine`.

    Single-event-loop discipline (like the engine itself is single-host):
    ``submit`` / ``shutdown`` are plain sync calls made from coroutines on
    the same loop that awaits :meth:`run` — there is no cross-thread
    hand-off anywhere.

    ``max_ticks`` bounds the total tick count like ``run_until_done``'s
    parameter does: exceeding it with work still pending raises
    ``EngineStalled`` rather than letting a wedged engine spin forever.
    """

    def __init__(
        self,
        engine,
        max_ticks: int = 10_000,
        on_tick: Optional[Callable[["AsyncFrontend", int], None]] = None,
    ):
        self.engine = engine
        self.max_ticks = max_ticks
        self.on_tick = on_tick
        self.ticks = 0
        self._accepting = True
        self._running = False
        #: req_id -> dict(stream=TokenStream, watermark=int).  The watermark
        #: is monotone (max semantics) so checkpoint-restore truncation of
        #: ``req.output`` never re-emits tokens.
        self._live: Dict[int, Dict] = {}
        self._wake = asyncio.Event()

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request) -> TokenStream:
        """Accept ``req`` (any time, including mid-flight) and return its
        token stream.  Raises ``RuntimeError`` after :meth:`shutdown`;
        engine-side validation errors (oversize prompt, bad SLO class)
        propagate synchronously from here, never from inside the loop."""
        if not self._accepting:
            raise RuntimeError(
                "AsyncFrontend is shut down; no new requests accepted"
            )
        self.engine.submit(req)          # validates + enqueues (EDF order)
        stream = TokenStream(req)
        self._live[req.req_id] = {
            "stream": stream, "watermark": len(req.output)
        }
        self._wake.set()                 # wake the loop if it is parked
        return stream

    def shutdown(self):
        """Close the front door.  :meth:`run` returns once every already
        accepted request has drained; idempotent."""
        self._accepting = False
        self._wake.set()

    # -- token pump ----------------------------------------------------------

    def _pump(self):
        """Emit committed tokens past each live request's watermark and
        close the streams of finished requests.  Max-watermark semantics:
        a restore may truncate ``req.output`` below the watermark, but the
        replayed suffix regenerates byte-identically, so waiting for the
        output to grow past the old watermark preserves exact ordering."""
        for req_id in list(self._live):
            entry = self._live[req_id]
            out = entry["stream"].req.output
            if len(out) > entry["watermark"]:
                entry["stream"]._push(out[entry["watermark"]:])
                entry["watermark"] = len(out)
            if entry["stream"].req.done:
                entry["stream"]._finish()
                del self._live[req_id]

    # -- serve loop ----------------------------------------------------------

    async def run(self) -> List[Request]:
        """The serve loop.  Ticks while the engine has work, parks when
        idle, returns the cumulative ``engine.finished`` list once
        :meth:`shutdown` has been called and in-flight work has drained."""
        from repro_torch.serving.engine import EngineStalled

        if self._running:
            raise RuntimeError("AsyncFrontend.run is already active")
        self._running = True
        try:
            while True:
                if self.engine.scheduler.has_work:
                    if self.ticks >= self.max_ticks:
                        raise EngineStalled(
                            f"max_ticks={self.max_ticks} exhausted with "
                            f"{len(self.engine.scheduler.waiting)} queued "
                            f"and {len(self.engine.scheduler.running)} "
                            "running requests",
                            diagnostics=self.engine.diagnostics(),
                            retired=list(self.engine.finished),
                        )
                    # Deliberately synchronous: the engine tick IS the
                    # loop's unit of work on the deterministic virtual-tick
                    # clock (async-vs-sync token identity is asserted on
                    # tick-exact interleavings).  Off-loop execution via
                    # to_thread would unorder submits relative to ticks.
                    self.engine.step()  # noqa: RPR004, RPT004
                    self.ticks += 1
                    self._pump()
                    if self.on_tick is not None:
                        self.on_tick(self, self.ticks)
                    # cooperative yield: consumers and submitters run
                    # between ticks, exactly once per tick.
                    await asyncio.sleep(0)
                    continue
                # idle: flush any straggler completions, then either exit
                # (shut down + drained) or park until a submit/shutdown.
                self._pump()
                if not self._accepting and not self._live:
                    return list(self.engine.finished)
                self._wake.clear()
                if self.engine.scheduler.has_work or not self._accepting:
                    continue             # work or shutdown raced the clear
                await self._wake.wait()
        finally:
            self._running = False

    async def drain(self):
        """Await completion of everything accepted so far WITHOUT closing
        admission.  :meth:`run` must be active on the same loop — if it
        is not (never started, or it raised), this raises rather than
        spinning forever on work that can no longer make progress."""
        await asyncio.sleep(0)       # let a just-created run() task start
        while self._live or self.engine.scheduler.has_work:
            if not self._running:
                raise RuntimeError(
                    "AsyncFrontend.drain: the serve loop is not active"
                )
            await asyncio.sleep(0)
