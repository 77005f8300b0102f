"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes wrappers,
their plain PyTorch versions (``ref.py``) and the device dispatch
(``ops.py``). A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises."""
