"""Utility subsystems: image I/O, configuration, checkpoints, profiling."""
