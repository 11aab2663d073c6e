"""PyTorch and CUDA port of distributed_llm_inference_tpu.

A package of its own beside the JAX one: it imports torch and never jax,
nor anything of the JAX package, and mirrors that package's layout so a
reader finds each counterpart. Plain tensor code is PyTorch; each Pallas
kernel of the JAX package becomes a hand-written Hopper kernel under
csrc/. Entry points (runtime.create_engine, the serving CLI) run on the
CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
