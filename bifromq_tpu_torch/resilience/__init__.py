"""Resilience plane of the port (copies from ``bifromq_tpu/resilience``):

- ``breaker``: the circuit breaker (closed → open → half-open) that
  guards the device.
- ``faults``: the process-global fault injector; its device-side rules
  (``service="tpu-device"``) hook the matcher's dispatch and fetch and
  the dispatch ring's readiness poll.
- ``device``: the device watchdog deadline, the buffer quarantine, the
  device breaker board and the bounded-slot admission under the ring.
- ``policy``: the per-call deadline budget the dist worker checks at
  each range's dispatch boundary.

Retry policies, the breaker registry of the RPC fabric, load shedding
and the ingest gate come with the MQTT frontend and the fabric
(ROADMAP A.5b).
"""
