"""Parallelism for the PyTorch port: the dp x pp x tp mesh of rank
processes over torch.distributed (mesh.py, comm.py), the partitioning of
parameters and KV (partition.py, vocab.py), the pipeline backend that
drives them (pipeline.py), the 1F1B schedule and the MPMD stage runtime's
planning (schedule.py), context parallelism (context.py, ring.py), and
meshes over several server processes (mesh.multihost_initialize with
serving/multihost.py)."""
