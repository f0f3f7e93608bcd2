"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers,
their plain PyTorch versions (``ref``) and the device dispatch (``ops``)."""
