"""The benchmark's harness: files found by name, seeded weights and
traffic, the closed-loop window, the profiler's reading, and the
comparison with the plain reference that decides ``correct``."""
