"""CPU tests of the port's benchmark; ``pytest benchmark/tests``."""
