"""Hand-written Hopper kernels for the perf-critical hot spots.

  optical_dft      — fused 4f pipeline: DAC quantize + DFT-as-matmul +
                     |.|^2, two CUDA kernels (``csrc/optical_dft.cu``)
  adc_dac          — fused converter boundary: DAC quantize + analog
                     noise + ADC at the global max, one CUDA kernel
                     (``csrc/adc_dac.cu``)
  local_attention  — causal / sliding-window GQA flash attention, the
                     full-sequence attention of the LM stack (prefill and
                     training), a CUDA forward and backward
                     (``csrc/local_attention.cu``)

``ops`` holds the public wrappers; ``ref`` the plain oracles; ``build``
compiles ``csrc/*.cu`` with nvcc on first use.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
