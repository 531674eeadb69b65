"""Adaptive batching framework (copy of ``bifromq_tpu/scheduler/batcher.py``;
≈ reference base-scheduler).

The reference funnels every data-path RPC through
``BatchCallScheduler``/``Batcher`` (base-scheduler .../Batcher.java:46):
calls are grouped by a batcher key, queued, and emitted as batches whose size
adapts to a moving-average latency budget (``maxBurstLatency``), with a
bounded pipeline of in-flight batches (trigger():186, batchAndEmit():201).

Here the same contract drives the device match plane: PUBLISH topics
accumulate per tenant and are emitted as device match batches; the latency
budget maps to device step cadence. Implemented on asyncio instead of
CompletableFuture chains — single-threaded, so no locks.

The reference's trace hooks (sampled callers' queue-wait spans, batch-emit
links) and its ``OBS`` tenant hooks (per-tenant queue-wait windows, emit
occupancy, the device gauge's scheduler registry) are ROADMAP A.10; the
per-call queue wait still feeds ``STAGES``.
"""

from __future__ import annotations

import asyncio
import time
from typing import (Awaitable, Callable, Dict, Generic, Hashable, List,
                    Optional, Sequence, Tuple, TypeVar)

from ..utils.metrics import STAGES

CallT = TypeVar("CallT")
ResultT = TypeVar("ResultT")

# process_batch(calls) -> results, one per call, same order
BatchFn = Callable[[Sequence[CallT]], Awaitable[Sequence[ResultT]]]


class EMA:
    """Exponential moving average (≈ base-scheduler EMALong)."""

    def __init__(self, alpha: float = 0.2, init: float = 0.0) -> None:
        self.alpha = alpha
        self.value = init

    def update(self, sample: float) -> float:
        self.value = (1 - self.alpha) * self.value + self.alpha * sample
        return self.value


class Batcher(Generic[CallT, ResultT]):
    """One batching pipeline (≈ Batcher.java:46).

    - bounded in-flight pipeline (``pipeline_depth``)
    - queue-depth-adaptive batch cap: the cap grows toward the
      throughput-optimal max while the queue stays SATURATED (depth at
      emit ≥ cap) within the latency budget, and decays back toward the
      idle cap while the queue runs SHALLOW — so after a burst drains,
      the next trickle of calls emits small batches (time-to-first-result)
      instead of padding to a stale burst-sized cap. A latency overrun
      still halves the cap (the ``maxBurstLatency`` guard).
    """

    #: cap a freshly-built (or drained-idle) batcher starts from
    IDLE_CAP = 64

    def __init__(self, process_batch: BatchFn, *,
                 pipeline_depth: Optional[int] = 2,
                 max_burst_latency: float = 0.010, max_batch_size: int = 8192,
                 min_batch_size: int = 1,
                 stage: Optional[str] = None,
                 shallow_decay: bool = True,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        if pipeline_depth is None:
            # one knob rules the whole pipeline — the batcher's
            # in-flight batches and the matcher's dispatch ring share
            # BIFROMQ_PIPELINE_DEPTH (double/triple buffering)
            from ..models.pipeline import pipeline_depth as _env_depth
            pipeline_depth = _env_depth()
        self._process = process_batch
        self._depth = pipeline_depth
        self._budget = max_burst_latency
        self._max_cap = max_batch_size
        self._idle_cap = min(max(min_batch_size, self.IDLE_CAP),
                             max_batch_size)
        self._cap = self._idle_cap
        self._min_cap = min_batch_size
        # injectable time source (fake-clock adaptive-sizing tests drive
        # the latency/depth signals deterministically)
        self._clock = clock
        # a named stage turns on enqueue→emit queue-wait attribution:
        # per-call histogram records under ``stage``
        self._stage = stage
        # queue entries: (call, fut, enqueue_perf)
        self._queue: List[Tuple[CallT, asyncio.Future, float]] = []
        self._inflight = 0
        self._latency = EMA(init=0.0)
        # queue depth observed at emit (EMA smooths one-batch spikes so a
        # single burst doesn't whipsaw the cap)
        self._depth_ema = EMA(alpha=0.3, init=0.0)
        # shallow-queue decay exists for time-to-first-result on SERVING
        # batchers; coalescers whose batches are purely throughput (the
        # worker's consensus-mutation batcher: one raft propose per
        # batch) opt out, or each bursty drain tail would shrink the cap
        # and the next burst would re-grow from idle in many small,
        # per-batch-expensive proposes
        self._shallow_decay = shallow_decay
        # strong refs: the loop only weakly references tasks, and a collected
        # batch task would strand every future in that batch
        self._tasks: set = set()
        self.batches_emitted = 0
        self.calls_submitted = 0
        self.last_activity = time.monotonic()

    def submit(self, call: CallT) -> "asyncio.Future[ResultT]":
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # the sampled caller's trace context and HLC start stamp: ROADMAP
        # A.10. Un-staged batchers (e.g. the worker's mutation coalescer)
        # skip the timing capture entirely — zero added hot-path cost
        self._queue.append((call, fut, self._clock()
                            if self._stage is not None else 0.0))
        self.calls_submitted += 1
        self.last_activity = time.monotonic()
        self._trigger()
        return fut

    @property
    def idle(self) -> bool:
        return not self._queue and self._inflight == 0

    @property
    def batch_cap(self) -> int:
        return self._cap

    @property
    def avg_latency(self) -> float:
        return self._latency.value

    @property
    def queue_depth(self) -> int:
        """Calls enqueued but not yet emitted."""
        return len(self._queue)

    def _trigger(self) -> None:
        while self._queue and self._inflight < self._depth:
            # depth BEFORE slicing: the saturation signal _adapt keys on
            # is "how much work was waiting when this batch emitted"
            depth_at_emit = len(self._queue)
            batch = self._queue[:self._cap]
            del self._queue[:len(batch)]
            self._inflight += 1
            self.batches_emitted += 1
            task = asyncio.get_running_loop().create_task(
                self._run(batch, depth_at_emit))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    async def _run(self, batch: List[Tuple], depth_at_emit: int = 0) -> None:
        calls = [b[0] for b in batch]
        start = self._clock()
        if self._stage is not None:
            # enqueue→emit queue-wait per call (the tenant SLO windows,
            # the deferred "batch.queue_wait" spans and the "batch.emit"
            # span linking every sampled caller: ROADMAP A.10)
            for _, _, enq in batch:
                STAGES.record(self._stage, start - enq)
        try:
            results = await self._process(calls)
            elapsed = self._clock() - start
            self._adapt(len(calls), elapsed, depth_at_emit)
            # OBS.profiler.record_emit: ROADMAP A.10
            for b, res in zip(batch, results):
                fut = b[1]
                if not fut.done():
                    fut.set_result(res)
        except Exception as e:  # noqa: BLE001 — batch failure fails all calls
            for b in batch:
                fut = b[1]
                if not fut.done():
                    fut.set_exception(e)
        finally:
            self._inflight -= 1
            self._trigger()

    def _adapt(self, batch_size: int, elapsed: float,
               depth_at_emit: int = 0) -> None:
        """Queue-depth-adaptive cap. Three regimes:

        - latency overrun ⇒ halve (unchanged ``maxBurstLatency`` guard);
        - saturated (the queue held ≥ a full cap when this batch emitted)
          within budget ⇒ double toward the throughput-optimal cap;
        - shallow (smoothed depth under a quarter cap) ⇒ decay halfway
          toward the idle cap, so the cap tracks the LIVE queue instead
          of whatever the last burst grew it to.
        """
        self._latency.update(elapsed)
        self._depth_ema.update(depth_at_emit)
        if elapsed > self._budget:
            self._cap = max(self._min_cap, self._cap // 2)
            return
        if (depth_at_emit >= self._cap
                and self._latency.value < self._budget / 2):
            self._cap = min(self._max_cap, self._cap * 2)
        elif (self._shallow_decay
                and self._depth_ema.value < self._cap / 4
                and self._cap > self._idle_cap):
            self._cap = max(self._idle_cap, self._cap // 2)


class BatchCallScheduler(Generic[CallT, ResultT]):
    """Routes calls to per-key Batchers (≈ BatchCallScheduler.java:48).

    Batchers are created lazily per key and reaped when idle (the reference
    expires them after inactivity; here reaping happens opportunistically).
    """

    def __init__(self, process_batch_for_key: Callable[
            [Hashable], BatchFn], *, pipeline_depth: Optional[int] = 2,
            max_burst_latency: float = 0.010,
            max_batch_size: int = 8192,
            stage: Optional[str] = None,
            shallow_decay: bool = True) -> None:
        self._factory = process_batch_for_key
        self._depth = pipeline_depth
        self._budget = max_burst_latency
        self._max_batch = max_batch_size
        self._stage = stage
        # the reference's obs_tenant_key opt-in (batcher keys are tenant
        # ids: the pub scheduler) feeds the tenant SLO registry: A.10
        self._shallow_decay = shallow_decay
        self._batchers: Dict[Hashable, Batcher] = {}
        self.calls_seen = 0
        # OBS.device.register_scheduler (the staged scheduler's queue
        # depth on the "device" gauges): ROADMAP A.10

    def batcher(self, key: Hashable) -> Batcher:
        b = self._batchers.get(key)
        if b is None:
            b = Batcher(self._factory(key), pipeline_depth=self._depth,
                        max_burst_latency=self._budget,
                        max_batch_size=self._max_batch,
                        stage=self._stage,
                        shallow_decay=self._shallow_decay)
            self._batchers[key] = b
        return b

    IDLE_REAP_SECS = 30.0

    def submit(self, key: Hashable, call: CallT) -> "asyncio.Future[ResultT]":
        fut = self.batcher(key).submit(call)
        # opportunistic reaping (the reference expires batchers after
        # inactivity): retired keys — e.g. merged-away ranges — must not
        # pin their Batcher state forever
        if len(self._batchers) > 8 and (self.calls_seen % 256) == 0:
            now = time.monotonic()
            for k in [k for k, b in self._batchers.items()
                      if k != key and b.idle
                      and now - b.last_activity > self.IDLE_REAP_SECS]:
                del self._batchers[k]
        self.calls_seen += 1
        return fut
