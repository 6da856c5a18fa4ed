"""Sparse operations of the port."""
