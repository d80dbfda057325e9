"""Evaluation and training engines of the port."""
