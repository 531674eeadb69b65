"""Extension points of the port (copies from ``bifromq_tpu/plugin``): the
ones the dist plane calls.

- ``events``: IEventCollector and the dist plane's event types.
- ``settings``: ISettingProvider and the per-tenant Setting defaults.
- ``subbroker``: ISubBroker, the delivery SPI the fan-out ends in.

Auth, throttling and client balancing come with the MQTT frontend
(ROADMAP A.5b).
"""
