"""Extension points of the port (copies from ``bifromq_tpu/plugin``): the
ones the dist plane and the retain service call.

- ``events``: IEventCollector and the dist and retain event types.
- ``settings``: ISettingProvider and the per-tenant Setting defaults.
- ``subbroker``: ISubBroker, the delivery SPI the fan-out ends in.
- ``throttler``: IResourceThrottler, the retain service's topic quota.

Auth and client balancing come with the MQTT frontend (ROADMAP A.5b).
"""
