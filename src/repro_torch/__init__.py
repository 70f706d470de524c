"""repro_torch: the PyTorch/CUDA port of the datapath offload engine and of
its LM consumer's serving and training paths.

Laid out module for module like `repro` (the JAX/Pallas reference), whose
counterpart each module names.  It imports torch and numpy, never jax and
nothing of `repro`.  Entry points run on the CUDA card unless the caller
asks for the CPU (`device="cpu"`), where the kernels' plain versions run.
"""
