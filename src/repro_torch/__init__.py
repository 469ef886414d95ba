"""PyTorch/CUDA port of the FSD-Inference reproduction.

The package mirrors ``src/repro`` module for module on the FSI main path
(``faas.simulator.run_fsi`` → ``core.fsi`` → ``core.backends`` →
``kernels.bsr_spmm``).  It imports ``torch`` and numpy, never the JAX
package; the numpy-only modules are kept as copies so that billing stays
bit-identical to the reference.  The compute runs on a CUDA card through
hand-written kernels unless the caller asks for the CPU.
"""
