"""Operators of the port: protocol, A = I - kD, the Wilson stencil."""
