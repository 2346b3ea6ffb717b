"""Command-line tools of the port (counterparts of ``tools/*.py``); each
runs as ``python -m detmatch_tpu_torch.tools.<name>``."""
