"""Kernels of the port: the DIA engine and the value-grid gather."""
