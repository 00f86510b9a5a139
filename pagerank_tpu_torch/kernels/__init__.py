"""Build machinery of the port's hand-written CUDA kernels
(``kernels/build.py``); the sources live in ``csrc/``."""
