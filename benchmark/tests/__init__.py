"""CPU tests of the benchmark harness; card tests are marked ``cuda``."""
