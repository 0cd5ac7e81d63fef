"""Launchers of the port: the slot server (``launch.serve``) and the DAG-FL
training entry point (``launch.train``)."""
