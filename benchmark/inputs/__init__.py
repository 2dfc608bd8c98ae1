"""Seeded input generators, one module each, found by the configuration's ``inputs.generator``."""
