"""Serving: the inline-SECDED ``ServingEngine`` and its reliability config."""
