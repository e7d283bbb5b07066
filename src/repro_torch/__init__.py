"""repro_torch — the PyTorch/CUDA port of the conversion-aware
analog-offload framework (Meech et al. 2023).

It mirrors ``repro``'s module layout and public names, imports ``torch``
and numpy only (never ``jax``, never ``repro``), and runs its entry points
on the CUDA card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
