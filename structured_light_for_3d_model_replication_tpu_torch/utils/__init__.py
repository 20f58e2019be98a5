"""Host-side helpers of the port: the pipelined finalize worker
(:mod:`.overlap`), structured logging (:mod:`.log`), the flight recorder
(:mod:`.events`), spans and metrics (:mod:`.trace`), program-build and
device-memory telemetry (:mod:`.telemetry`) and the runtime sanitizers
(:mod:`.sanitize`)."""
