"""The examples (PyTorch port), twins of the reference's ``examples/``:

  quickstart      — the paper in five minutes: the 4f physics against a
                    digital oracle, the Fig. 8 price, the decision rule
  optical_offload — the offload runtime end to end in 10 steps: profile,
                    plan, execute, verify, scale out, trickle, tile,
                    observe, survive, reuse

Each runs as ``python -m repro_torch.examples.<name> [--device cpu]``, on
the CUDA card unless ``--device cpu`` is given.
"""
