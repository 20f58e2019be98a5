"""Host-side codecs of the port (numpy only)."""
