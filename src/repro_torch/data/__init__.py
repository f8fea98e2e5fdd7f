"""Numpy data of the port: synthetic datasets and federated partitions
(bit-equal copies of the reference's numpy code)."""
