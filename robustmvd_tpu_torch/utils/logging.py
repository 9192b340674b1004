"""Logging to stdout and to any number of attached log files

(reference: rmvd/utils/logging.py:33-125): what the data layer, the
evaluation and its CLI log."""

from __future__ import annotations

import threading
from datetime import datetime

_files = {}
_lock = threading.Lock()


def add_log_file(path, flush_line=True):
    with _lock:
        if path not in _files:
            _files[path] = (open(path, "a"), flush_line)


def remove_log_file(path):
    with _lock:
        entry = _files.pop(path, None)
    if entry is not None:
        entry[0].close()


def info(*args):
    line = f"[{datetime.now().strftime('%Y-%m-%d %H:%M:%S')}] [INFO] {' '.join(str(a) for a in args)}"
    print(line, flush=True)
    with _lock:
        for f, flush_line in _files.values():
            f.write(line + "\n")
            if flush_line:
                f.flush()
