"""Parallelism for the PyTorch port: the dp x pp x tp mesh of rank
processes over torch.distributed (mesh.py, comm.py), the partitioning of
parameters and KV (partition.py, vocab.py), the pipeline backend that
drives them (pipeline.py), and the planning half of the JAX package's
schedule.py (the MPMD stage runtime's layer split and its 1F1B order).
Microbatching, context parallelism, expert meshes and multi-host meshes
are part B of the Multi-GPU SPMD item of ROADMAP.md."""
