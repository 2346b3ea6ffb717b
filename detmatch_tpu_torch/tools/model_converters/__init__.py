"""Checkpoint converters (counterparts of ``tools/model_converters/``):
``python -m detmatch_tpu_torch.tools.model_converters.<name>``."""
