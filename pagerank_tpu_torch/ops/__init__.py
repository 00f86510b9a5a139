"""Sparse ops of the PyTorch/CUDA port (the L3 hot path).

Port of ``pagerank_tpu/ops/__init__.py``. ``LANES`` is the one spelling
of the dst-block width. On the TPU it was the 128-lane vector register;
on Hopper a 128-lane dst block is one CTA of 128 threads (4 warps), one
thread per lane, so the layout is kept as is and the packed arrays stay
bit-equal to the JAX package's.
"""

LANES = 128
