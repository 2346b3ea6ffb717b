"""Structured training logs: one JSON object per line in ``log.json``
(counterpart of ``detmatch_tpu/utils/logging.py``, the reference's mmcv
log.json format that ``tools/analyze_logs.py`` and
``tools/average_runs.py`` read), echoed to stderr, and
:class:`MultiLogger`, which fans one entry out to several sinks (the
tensorboard sink is ``train/tensorboard.py``), and the
:class:`NullLogger` of the other processes of a multi-process run."""
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
        if not self.echo:
            return
        it = entry.get("iter", "?")
        if entry.get("mode") == "val":
            n = sum(1 for k in entry if k not in ("iter", "mode"))
            print(f"[iter {it}] eval: {n} metrics logged", file=sys.stderr)
        else:
            print(f"[iter {it}] loss={entry.get('loss', float('nan')):.4f} "
                  f"({entry.get('time', 0.0):.3f}s/iter)", file=sys.stderr)

    def close(self):
        self._f.close()


class NullLogger:
    """A logger that writes nothing: the sink of every process but the
    first in a multi-process run."""

    def log(self, entry: dict):
        pass

    def log_image(self, tag, img, step):
        pass

    def close(self):
        pass


class MultiLogger:
    """Fan-out to several sinks (None entries dropped); used where a
    :class:`JsonlLogger` is."""

    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def log(self, entry: dict):
        for s in self.sinks:
            s.log(entry)

    def log_image(self, tag, img, step):
        for s in self.sinks:
            if hasattr(s, "log_image"):
                s.log_image(tag, img, step)

    def close(self):
        for s in self.sinks:
            s.close()
