"""PyTorch/CUDA port of the CM compiler, simulator and serving runtime.

Mirrors ``repro`` (the JAX package, which stays the reference): ``core``
compiles and simulates a CM pipeline, ``runtime`` serves requests on it, and
the simulator's crossbar MxVs run on an NVIDIA card through
``core.TorchPlane`` and the hand-written kernels in ``kernels``.  Nothing
here imports ``jax`` or ``repro``.
"""
