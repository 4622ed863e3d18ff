"""Host-side I/O helpers of the port (scan-mode sweep read-ahead)."""
