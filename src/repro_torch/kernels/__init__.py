"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes wrappers,
their plain PyTorch versions (``ref.py``) and the device dispatch
(``ops.py``), and the kernel guard on every CUDA dispatch (``guard/``).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises."""
