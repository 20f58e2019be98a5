"""Host-side helpers of the port: the pipelined finalize worker
(:mod:`.overlap`)."""
