"""Native (C++) kernels for host-side runtime stages.

Currently: the ARACNE DPI intersection kernel (built on demand with
g++ via ctypes; see aracne_native.py).  The accelerator path itself is
JAX/XLA — native code here covers the CPU-bound graph stage, mirroring
the reference's use of native code for its runtime (ARACNE.hpp).
"""
