"""PyTorch/CUDA port of the RL pod scheduler (the JAX package ``repro`` is
the reference).  See README.md, "PyTorch/CUDA port"."""
