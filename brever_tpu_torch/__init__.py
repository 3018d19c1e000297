"""brever_tpu_torch — the PyTorch/CUDA port of brever_tpu.

A second package beside the JAX reference, ``brever_tpu``: the same
models and entry points in PyTorch, with the Pallas TPU kernels
rewritten by hand for NVIDIA Hopper (``csrc/``). Importing the package
loads nothing heavy; the CUDA kernels are built at first use.
"""

__version__ = '0.1.0'
