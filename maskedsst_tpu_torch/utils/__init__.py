"""Helpers shared by the port's drivers and tools."""
