"""Launchers of the port: the slot server (``launch.serve``)."""
