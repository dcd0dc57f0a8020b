"""Utilities of the port."""
