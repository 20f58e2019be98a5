"""Fault injection for the serving layer and the capture path
(:mod:`.faults`: seeded call schedules, device-fault plans and the
launch-boundary wrappers the serve worker uses). The capture transports of
the JAX package's ``hw/`` (cameras, projector, turntable, command server)
are not part of the port."""
