"""The plain FP64 reference of the benchmark's heat slabs (PyTorch and
NumPy only; it imports nothing of the program under test)."""
