"""Utilities of the port: checkpoints, weight loading, and the port's own
copies of the host-side metrics, NIfTI I/O and visualizer."""
