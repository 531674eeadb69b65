"""The port's adaptive batcher (``scheduler/batcher.py``), which emits the
dist plane's pub batches and coalesces its consensus mutations.

Mirrors ``tests/test_batcher.py`` and the queue-depth-adaptive cap tests
of ``tests/test_pipeline.py`` (``TestAdaptiveSizing``) on the port's
``Batcher`` / ``BatchCallScheduler``, and holds the port against the
reference on scripted bursts and trickles under a fake clock: the same
calls give the same batch sizes and the same cap after every batch. The
comparison is of behaviour, not of timings.
"""

import asyncio

import pytest

from bifromq_tpu.scheduler.batcher import Batcher as RBatcher
from bifromq_tpu_torch.scheduler.batcher import BatchCallScheduler, Batcher
from bifromq_tpu_torch.utils.metrics import STAGES


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class TestBatcher:
    async def test_results_in_order(self):
        async def process(calls):
            return [c * 2 for c in calls]

        b = Batcher(process)
        futs = [b.submit(i) for i in range(100)]
        results = await asyncio.gather(*futs)
        assert results == [i * 2 for i in range(100)]

    async def test_batching_happens(self):
        sizes = []

        async def process(calls):
            sizes.append(len(calls))
            await asyncio.sleep(0.001)
            return list(calls)

        b = Batcher(process, pipeline_depth=1)
        futs = [b.submit(i) for i in range(50)]
        await asyncio.gather(*futs)
        # pipeline depth 1: first batch emits immediately; the rest coalesce
        assert len(sizes) < 50
        assert sum(sizes) == 50

    async def test_pipeline_depth_respected(self):
        inflight = 0
        peak = 0

        async def process(calls):
            nonlocal inflight, peak
            inflight += 1
            peak = max(peak, inflight)
            await asyncio.sleep(0)
            inflight -= 1
            return list(calls)

        b = Batcher(process, pipeline_depth=2, max_batch_size=4)
        futs = [b.submit(i) for i in range(64)]
        await asyncio.gather(*futs)
        assert peak == 2

    async def test_cap_shrinks_on_overrun(self):
        clk = FakeClock()

        async def slow(calls):
            clk.advance(0.02)
            return list(calls)

        b = Batcher(slow, max_burst_latency=0.001, clock=clk)
        start_cap = b.batch_cap
        futs = [b.submit(i) for i in range(200)]
        await asyncio.gather(*futs)
        assert b.batch_cap < start_cap

    async def test_cap_grows_when_fast(self):
        async def fast(calls):
            return list(calls)

        b = Batcher(fast, max_burst_latency=0.5, pipeline_depth=1)
        for _ in range(20):
            futs = [b.submit(i) for i in range(b.batch_cap * 2)]
            await asyncio.gather(*futs)
        assert b.batch_cap > 64

    async def test_failure_fails_batch(self):
        async def boom(calls):
            raise RuntimeError("nope")

        b = Batcher(boom)
        fut = b.submit(1)
        with pytest.raises(RuntimeError):
            await fut

    async def test_staged_batcher_records_queue_wait(self):
        clk = FakeClock()

        async def process(calls):
            return list(calls)

        STAGES.hist("queue_wait").reset()
        b = Batcher(process, stage="queue_wait", clock=clk)
        futs = [b.submit(i) for i in range(3)]
        clk.advance(0.004)
        await asyncio.gather(*futs)
        h = STAGES.hist("queue_wait")
        assert h.count == 3
        # every call waited the 4 ms the clock moved before its batch ran
        # (log2 buckets: the upper edge of the 4 ms bucket)
        assert 0.004 <= h.percentile_ms(99) / 1e3 <= 0.0082


class TestAdaptiveSizing:
    async def test_deep_queue_grows_cap(self):
        clk = FakeClock()

        async def fast(calls):
            clk.advance(0.001)
            return list(calls)

        b = Batcher(fast, max_burst_latency=0.5, pipeline_depth=1,
                    clock=clk)
        for _ in range(6):
            futs = [b.submit(i) for i in range(b.batch_cap * 2)]
            await asyncio.gather(*futs)
        assert b.batch_cap > Batcher.IDLE_CAP

    async def test_shallow_queue_emits_small_batches(self):
        clk = FakeClock()
        sizes = []

        async def fast(calls):
            sizes.append(len(calls))
            clk.advance(0.001)
            return list(calls)

        b = Batcher(fast, max_burst_latency=0.5, pipeline_depth=2,
                    clock=clk)
        for i in range(10):
            await b.submit(i)
        assert sizes == [1] * 10
        assert b.batch_cap == Batcher.IDLE_CAP

    @pytest.mark.parametrize("shallow_decay", [True, False])
    async def test_cap_after_burst_drains(self, shallow_decay):
        """A serving batcher's cap decays back to idle under a trickle; a
        coalescer's (``shallow_decay=False``, the worker's consensus
        mutations) keeps its grown cap, and still halves on overrun."""
        clk = FakeClock()
        step = [0.001]

        async def fast(calls):
            clk.advance(step[0])
            return list(calls)

        b = Batcher(fast, max_burst_latency=0.5, pipeline_depth=1,
                    shallow_decay=shallow_decay, clock=clk)
        for _ in range(6):
            futs = [b.submit(i) for i in range(b.batch_cap * 2)]
            await asyncio.gather(*futs)
        grown = b.batch_cap
        assert grown > Batcher.IDLE_CAP
        for i in range(80):
            await b.submit(i)
        assert b.batch_cap == (Batcher.IDLE_CAP if shallow_decay
                               else grown)
        step[0] = 1.0
        futs = [b.submit(i) for i in range(b.batch_cap)]
        await asyncio.gather(*futs)
        assert b.batch_cap < (Batcher.IDLE_CAP if shallow_decay else grown)


async def _script(cls, **kw):
    """Bursts, a trickle and overruns under a fake clock: every batch's
    size and the cap it was cut at."""
    clk = FakeClock()
    cost = [0.001]
    trace = []
    b = None

    async def process(calls):
        clk.advance(cost[0] * len(calls) ** 0.5)
        trace.append((len(calls), b.batch_cap))
        return list(calls)

    b = cls(process, max_burst_latency=0.05, clock=clk, **kw)
    for burst in (40, 300, 1000, 5, 700):
        await asyncio.gather(*(b.submit(i) for i in range(burst)))
    for i in range(30):
        await b.submit(i)
    cost[0] = 0.02
    await asyncio.gather(*(b.submit(i) for i in range(500)))
    trace.append(("end", b.batch_cap, b.batches_emitted,
                  b.calls_submitted))
    return trace


@pytest.mark.parametrize("kw", [
    {"pipeline_depth": 1},
    {"pipeline_depth": 2},
    {"pipeline_depth": 1, "shallow_decay": False, "max_batch_size": 256},
], ids=["depth1", "depth2", "coalescer"])
async def test_batcher_parity_with_reference(kw):
    ref = await _script(RBatcher, **kw)
    assert await _script(Batcher, **kw) == ref
    assert len(ref) > 20


class TestScheduler:
    async def test_per_key_isolation(self):
        seen = {}

        def factory(key):
            async def process(calls):
                seen.setdefault(key, []).extend(calls)
                return list(calls)
            return process

        s = BatchCallScheduler(factory)
        await asyncio.gather(s.submit("a", 1), s.submit("b", 2),
                             s.submit("a", 3))
        assert sorted(seen["a"]) == [1, 3]
        assert seen["b"] == [2]

    async def test_idle_batchers_are_reaped(self):
        def factory(key):
            async def process(calls):
                return list(calls)
            return process

        s = BatchCallScheduler(factory)
        s.IDLE_REAP_SECS = 0.0
        for k in range(12):
            await s.submit(k, k)
        # the reap runs on every 256th call once more than 8 keys exist
        s.calls_seen = 256
        await s.submit("live", 0)
        assert set(s._batchers) == {"live"}
