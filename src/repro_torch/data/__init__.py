"""Datasets of the port (pure numpy, byte-identical to the reference's)."""
