"""Configs of the port: the DAG-FL deployment and the paper tasks."""
