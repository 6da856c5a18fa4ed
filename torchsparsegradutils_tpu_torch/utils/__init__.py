"""Generators of the port."""
