"""PyTorch/CUDA port of the Auptimizer HPO framework for NVIDIA Hopper.

Same layout as the JAX package ``repro``: each module sits at the same
relative path as the module it is held against.  The package imports
``torch``, numpy and the standard library only.
"""
