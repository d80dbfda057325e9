"""Evaluation engine of the port."""
