"""Observability of the port: sparsity telemetry."""
