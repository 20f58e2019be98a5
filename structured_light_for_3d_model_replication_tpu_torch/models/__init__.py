"""End-to-end workflows of the port (single stop, 360° ring)."""
