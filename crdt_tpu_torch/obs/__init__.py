"""Observability of the port: kernel launch counters."""
