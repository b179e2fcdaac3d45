"""Drivers: one per kind of entry into the program, each with ``run(r)``."""
