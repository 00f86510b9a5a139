"""Host utilities of the port: config, synthetic graphs, local I/O,
snapshots."""
