"""Experiment runners of the port: the round-loop engine and run_permfl."""
