"""detmatch_tpu_torch: the PyTorch + CUDA port of ``detmatch_tpu``.

Same sub-layout and module names as ``detmatch_tpu`` so each counterpart
is easy to find; parameters follow the pcdet (OpenPCDet) state-dict
names, so a reference ``.pth`` loads with ``load_state_dict``. The TPU
Pallas kernels on the PV-RCNN inference and training paths are
hand-written CUDA kernels for Hopper under ``csrc/``, bound through
``ops/cuda/``; each has a plain PyTorch twin that CPU tensors take.

This package imports ``torch`` and numpy, never ``jax`` or ``flax``.
"""

__version__ = "0.1.0"
