"""allpathslg_tpu_torch — the PyTorch + CUDA port of allpathslg_tpu.

Mirrors allpathslg_tpu module for module, so each port file has one
reference file to be held against; the JAX package is the reference and
the parity tests (tests/test_torch_*.py) feed both the same numpy inputs.
This package imports torch and never jax or allpathslg_tpu.

Ported so far: the contig slice (reads in; 25-mer spectra, corrected
reads, filled fragments, unipaths, contigs and the assembly report out)
and the fragment alignment (align_frags), plus the flagship spectrum step.
Two Pallas kernels of the reference are hand-written CUDA kernels for
Hopper here: the k-mer sort (ops/pallas/sort_pallas.py::sort_two_words ->
csrc/radix_sort.cu, ops/cuda/sort_cuda.py), through which every k-mer key
sort runs on a CUDA device, and the bit-parallel banded DP
(ops/pallas/banded_bp.py::banded_align_bp -> csrc/banded_bp.cu,
ops/cuda/banded_cuda.py) of align_frags' gapped rescue. Host-only numpy
modules of the reference (io/, graph/cleanup, asm/localize, ...) are
copies with their imports pointed at the port.
"""

__version__ = "0.1.0"
