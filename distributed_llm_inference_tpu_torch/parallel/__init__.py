"""Parallelism for the PyTorch port. Today only the pure planning half of
the JAX package's parallel/schedule.py (the MPMD stage runtime's layer
split and its 1F1B order); the meshes and their programs are the
Multi-GPU SPMD item of ROADMAP.md."""
