"""allpathslg_tpu_torch — the PyTorch + CUDA port of allpathslg_tpu.

Mirrors allpathslg_tpu module for module, so each port file has one
reference file to be held against; the JAX package is the reference and
the parity tests (tests/test_torch_*.py) feed both the same numpy inputs.
This package imports torch and never jax or allpathslg_tpu.

Ported so far: the error-correction front of the contig slice (reads in;
25-mer spectra, pre-corrected reads, the strong K=24 table and corrected,
cleaned reads out) and the flagship spectrum step. The reference's Pallas
sort kernel (ops/pallas/sort_pallas.py::sort_two_words) is a hand-written
CUDA radix sort for Hopper here (csrc/radix_sort.cu, ops/cuda/sort_cuda.py)
that every k-mer key sort of the slice goes through on a CUDA device.
"""

__version__ = "0.1.0"
