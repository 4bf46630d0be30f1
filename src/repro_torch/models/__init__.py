"""The model stack: configs, layers, GQA attention over the flash kernel,
the ``LM`` (serving, and the loss training differentiates) and the
conversions to and from the reference's parameter layout."""
from repro_torch.models.config import ModelConfig, group_pattern
from repro_torch.models.transformer import LM
from repro_torch.models.weights import params_from_reference

__all__ = ["LM", "ModelConfig", "group_pattern", "params_from_reference"]
