"""A leveled logger that prints to stdout and to any number of attached

log files (reference: rmvd/utils/logging.py:33-125): what the data layer,
the evaluation, the training and the CLIs log. ``logger`` is the one
instance; the module's functions are its methods."""

from __future__ import annotations

import threading
from datetime import datetime

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


class _Logger:
    def __init__(self):
        self.level = _LEVELS["info"]
        self._files = {}
        self._lock = threading.Lock()

    def set_level(self, level):
        self.level = _LEVELS[level]

    def add_log_file(self, path, flush_line=True):
        with self._lock:
            if path not in self._files:
                self._files[path] = (open(path, "a"), flush_line)

    def remove_log_file(self, path):
        with self._lock:
            entry = self._files.pop(path, None)
        if entry is not None:
            entry[0].close()

    def log(self, level, *args):
        if _LEVELS[level] < self.level:
            return
        line = f"[{datetime.now().strftime('%Y-%m-%d %H:%M:%S')}] [{level.upper()}] {' '.join(str(a) for a in args)}"
        print(line, flush=True)
        with self._lock:
            for f, flush_line in self._files.values():
                f.write(line + "\n")
                if flush_line:
                    f.flush()

    def debug(self, *args):
        self.log("debug", *args)

    def info(self, *args):
        self.log("info", *args)

    def warning(self, *args):
        self.log("warning", *args)

    def error(self, *args):
        self.log("error", *args)


logger = _Logger()

set_level = logger.set_level
add_log_file = logger.add_log_file
remove_log_file = logger.remove_log_file
debug = logger.debug
info = logger.info
warning = logger.warning
error = logger.error
