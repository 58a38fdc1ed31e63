"""Utility programs of the port's examples."""
