"""The plain reference of the benchmark's correctness check (`sph.py`)."""
