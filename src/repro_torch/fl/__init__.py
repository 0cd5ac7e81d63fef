"""The FL simulator of the port: latency, nodes, tasks and systems."""
