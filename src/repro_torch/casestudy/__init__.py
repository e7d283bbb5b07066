"""The paper's case study (PyTorch port): the 27-benchmark Amdahl suite
(Table 1 / Fig. 9) and the figures beside it.

Each module is the twin of the reference's file of the same name under
``benchmarks/``:

  optics_sim            — the Fourier-optics library the optics benchmarks use
  amdahl_suite          — the 27 benchmarks, ``run_suite`` (Table 1)
  conversion_bottleneck — prototype optical FT vs software FFT (Fig. 8)
  pareto                — the DAC/ADC Pareto frontier (Fig. 2)
  complexity_fig        — compute vs conversion complexity (Fig. 3)
  run                   — ``python -m repro_torch.casestudy.run``
"""
