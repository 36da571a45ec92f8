"""Launchers: the block-runtime driver and its canonical workloads."""
