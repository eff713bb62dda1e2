"""Solvers of the port: flexible GCR, its parameters and results."""
