"""Numpy data of the port: synthetic datasets, federated partitions and
token streams for LM training (bit-equal copies of the reference's numpy
code)."""
