"""Kernels of the port: the DIA engine, the chunk engine and the value
gather."""
