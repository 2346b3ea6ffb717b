"""Tensorboard scalar and image sink of the SSL loop (counterpart of
``detmatch_tpu/utils/logging.py:TensorBoardSink``; the reference's
TensorboardLoggerHook role, ``split_0.py:877-887``), through
``torch.utils.tensorboard``. Where that cannot be imported (it needs the
``tensorboard`` package), the sink does nothing and says so once on
stderr."""
from __future__ import annotations

import sys


class TensorBoardSink:
    def __init__(self, log_dir):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print(f"tensorboard sink disabled: {e}", file=sys.stderr)
            self._w = None
        else:
            self._w = SummaryWriter(log_dir=log_dir)

    def log(self, entry: dict):
        """Every numeric value of ``entry`` as the scalar
        ``<mode>/<key>`` at step ``iter``."""
        if self._w is None:
            return
        step = int(entry.get("iter", 0))
        prefix = entry.get("mode", "train")
        for k, v in entry.items():
            if k in ("iter", "mode"):
                continue
            try:
                self._w.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass
        self._w.flush()

    def log_image(self, tag, img_hwc_uint8, step):
        if self._w is not None:
            self._w.add_image(tag, img_hwc_uint8, step, dataformats="HWC")

    def close(self):
        if self._w is not None:
            self._w.close()
