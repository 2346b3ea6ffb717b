"""Structured training logs: one JSON object per line in ``log.json``
(counterpart of ``detmatch_tpu/utils/logging.py:JsonlLogger``, the
reference's mmcv log.json format), echoed to stderr."""
from __future__ import annotations

import json
import sys


class JsonlLogger:
    def __init__(self, path, echo=True):
        self.path = path
        self.echo = echo
        self._f = open(path, "a")

    def log(self, entry: dict):
        self._f.write(json.dumps(entry) + "\n")
        self._f.flush()
        if self.echo:
            print(f"[iter {entry.get('iter', '?')}] "
                  f"loss={entry.get('loss', float('nan')):.4f} "
                  f"({entry.get('time', 0.0):.3f}s/iter)", file=sys.stderr)

    def close(self):
        self._f.close()
