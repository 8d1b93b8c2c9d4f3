"""Committed workload data of the port (``workloads/data/``)."""
