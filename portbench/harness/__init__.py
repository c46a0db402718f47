"""The benchmark harness of the PyTorch and CUDA port: it finds a cell's
configuration, traffic mix, limits and per-layer metric readers by name,
drives the port's serve or train loop on the card, reads the trace and
checks the output against the plain reference in ``portbench/reference``."""
