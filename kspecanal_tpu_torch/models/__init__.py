"""Mode state machines of the port (zero-span, scan)."""
