"""The observability plane (counterpart of h2o3_tpu/obs/).

Reference: H2O-3 ships node-level introspection as a first-class
subsystem (water/TimeLine.java ring, /3/Timeline, /3/Logs, WaterMeter,
/3/Profiler). This package is that layer for the port:

- :mod:`h2o3_tpu_torch.obs.metrics` — a process-wide metrics registry
  (counters / gauges / histograms with bounded label sets) served on
  ``GET /3/Metrics`` in Prometheus text exposition and JSON.
- :mod:`h2o3_tpu_torch.obs.tracing` — trace spans: a span id minted at
  REST ingress, child spans from Rapids, ingest and the scoring path,
  ``GET /3/Trace/{id}``; no span adds a device sync.
- :mod:`h2o3_tpu_torch.obs.flight` — the flight recorder: on a fatal
  signal (or on request) the timeline ring, open spans and a metrics
  snapshot persist atomically (``GET /3/FlightRecords``).
- :mod:`h2o3_tpu_torch.obs.phases` — the lifecycle phases
  (``backend_init`` … ``server_start``) with deadlines.
- :mod:`h2o3_tpu_torch.obs.compiles` — the compile ledger of the
  port's graph captures, exports and compiler builds, served on
  ``GET /3/Runtime`` and folded into ``/3/Metrics``.

Import cost: the standard library only; the framework modules load
lazily inside callbacks."""

from h2o3_tpu_torch.obs import (compiles, flight, metrics,  # noqa: F401
                          phases, tracing)
