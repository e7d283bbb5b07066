"""Hand-written Hopper kernels for the perf-critical hot spots.

  optical_dft      — fused 4f pipeline: DAC quantize + DFT-as-matmul +
                     |.|^2, two CUDA kernels (``csrc/optical_dft.cu``)
  local_attention  — causal / sliding-window GQA flash attention, the
                     prefill attention of the LM stack, one CUDA kernel
                     (``csrc/local_attention.cu``)

``ops`` holds the public wrappers; ``ref`` the plain oracles; ``build``
compiles ``csrc/*.cu`` with nvcc on first use.  The reference's
``converter_boundary`` kernel is not ported yet.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
