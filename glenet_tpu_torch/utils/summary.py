"""Training / eval scalar telemetry (the port's own copy of
glenet_tpu/utils/summary.py).

Writes tensorboard event files when tensorboardX is importable and always
mirrors the scalars to a greppable `scalars.jsonl` (one JSON object per
write), so headless runs keep a record without the TB UI.
"""
from __future__ import annotations

import json
from pathlib import Path


class ScalarWriter:
    def __init__(self, log_dir, enabled: bool = True):
        self.enabled = enabled
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(log_dir=str(log_dir))
        except ImportError:
            self._tb = None
        self._jsonl = open(log_dir / 'scalars.jsonl', 'a')

    def add_scalar(self, tag, value, step):
        if not self.enabled:
            return
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, int(step))
        self._jsonl.write(json.dumps(
            {'tag': tag, 'value': value, 'step': int(step)}) + '\n')

    def add_scalars(self, scalars: dict, step):
        for tag, value in scalars.items():
            try:
                self.add_scalar(tag, float(value), step)
            except (TypeError, ValueError):
                pass
        if self.enabled and self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
