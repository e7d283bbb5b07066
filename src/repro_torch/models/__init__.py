"""Model substrate: configs, parameter templates, and the LM assembly."""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig
from repro_torch.models.model import LM
from repro_torch.models.params import (compute_params, init_params,
                                       param_counts)

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "LM", "init_params",
           "param_counts", "compute_params"]
