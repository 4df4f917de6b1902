"""PyTorch and CUDA port of cal_tpu for NVIDIA Hopper (H100).

The JAX package ``cal_tpu`` beside this one is the reference.  This package
imports ``torch`` and NumPy only, never JAX or ``cal_tpu``.  Every TPU kernel
on a ported path is a hand-written CUDA kernel under ``csrc/`` (built with
nvcc for sm_90a at first use, see ``kernels/build.py``), with a plain PyTorch
twin in the same module that CPU tensors take.
"""
