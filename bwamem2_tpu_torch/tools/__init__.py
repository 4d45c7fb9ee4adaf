"""Stand-alone tools of the port (probes run on the device)."""
