"""Console and reproducibility set-up (port of ``gs_tpu/utils/console.py``).

The reference's ``safe_state`` (``utils/general_utils.py:130-151``) wraps
stdout so that every line ends with a timestamp, silences it under
``--quiet``, and seeds the host RNGs. gs_tpu replaces ``sys.stdout`` for
good; here ``safe_state`` is a context manager that puts the stream back on
exit, so a CLI's ``main`` called in-process (``chip_smoke.py``, the tests)
leaves its caller's stdout as it found it. The reference's ``cuda:0`` pin
is the CLIs' ``device`` argument.
"""

from __future__ import annotations

import contextlib
import random
import sys
from datetime import datetime

import numpy as np
import torch


class _TimestampedStream:
    def __init__(self, stream, silent: bool):
        self._stream = stream
        self._silent = silent

    def write(self, text: str):
        if self._silent:
            return len(text)
        if text.endswith("\n"):
            body = text[:-1]
            if body:
                stamp = datetime.now().strftime("%d/%m %H:%M:%S")
                text = body.replace("\n", f" [{stamp}]\n") + f" [{stamp}]\n"
        return self._stream.write(text)

    def flush(self):
        self._stream.flush()

    def __getattr__(self, name):
        return getattr(self._stream, name)


@contextlib.contextmanager
def safe_state(silent: bool = False, seed: int = 0):
    """Timestamp (or silence) stdout and seed the host RNGs and torch's
    for the block; stdout is restored when it ends, also on an exception."""
    saved = sys.stdout
    sys.stdout = _TimestampedStream(saved, silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    try:
        yield
    finally:
        sys.stdout = saved
