"""Submission tools of the port: the BMP codec and the NTIRE packager/validator."""
