"""Result and checkpoint tools (counterparts of ``tools/misc/``): each
runs as ``python -m detmatch_tpu_torch.tools.misc.<name>``."""
