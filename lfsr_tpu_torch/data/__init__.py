"""Data records of the port."""
