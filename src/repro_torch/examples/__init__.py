"""The examples (PyTorch port), twins of the reference's ``examples/``:

  quickstart      — the paper in five minutes: the 4f physics against a
                    digital oracle, the Fig. 8 price, the decision rule
  optical_offload — the offload runtime end to end in 10 steps: profile,
                    plan, execute, verify, scale out, trickle, tile,
                    observe, survive, reuse
  serve_lm        — continuous batching of 10 requests on the smoke
                    recurrentgemma-9b (RG-LRU + local attention)
  train_lm        — xlstm-125m at full width on the Markov task, with
                    checkpoints and the fault-tolerant runner

Each runs as ``python -m repro_torch.examples.<name> [--device cpu]``, on
the CUDA card unless ``--device cpu`` is given.
"""
