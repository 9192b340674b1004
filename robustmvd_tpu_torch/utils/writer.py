"""Buffered event writer flushing to ``events.jsonl`` and TensorBoard (or wandb).

The JAX package's ``utils/writer.py`` in torch (reference:
rmvd/utils/writer.py:31-398): a module-level store that ``put_scalar``,
``put_scalar_dict``, ``put_scalar_list``, ``put_tensor``, ``put_histogram``
and ``put_time`` append to, and ``write_out_storage`` flushes. The scalars
always go to ``<out_dir>/events.jsonl``, one JSON object per line in the JAX
package's format (``{"type", "name", "value", "step"}``); TensorBoard and
wandb get every event where they import. A backend that was asked for and
does not import leaves the run going, as the JAX writer does, and is named
once through ``utils.logging``.

TensorBoard's event file is written with the ``tensorboard`` package's
protocol buffers and record format (:class:`TensorBoardFile`): the records
of ``torch.utils.tensorboard.SummaryWriter`` (simple-value scalars, PNG
images, histograms over its default bins), without its module, which
imports TensorFlow wherever that is installed (and TensorFlow's keras
imports JAX; 13 s on the CPU test machine).
``TimeWriter`` times a block on the host clock, with the running average and
the ETA.

Values may be CUDA tensors: ``_to_py`` reads a scalar with ``.item()``, the
one synchronisation, and ``put_tensor`` / ``put_histogram`` copy to the host
when the event is buffered.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import socket
import time
from collections import defaultdict

import numpy as np

from . import logging

_EVENT_STORAGE = []
_writers = []
_jsonl_path = None
_durations = defaultdict(lambda: {"total": 0.0, "count": 0})
_file_ids = itertools.count()


def setup_writers(log_tensorboard=True, log_wandb=False, out_dir=None):
    """Initialise the backends (reference: writer.py:250-274), closing those
    of an earlier call. Without ``out_dir`` no event is written anywhere."""
    global _jsonl_path
    for kind, w in _writers:
        if kind == "tb":
            w.close()
    _writers.clear()
    _jsonl_path = None
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    _jsonl_path = os.path.join(out_dir, "events.jsonl")
    if log_tensorboard:
        try:
            _writers.append(("tb", TensorBoardFile(out_dir)))
        except ImportError as e:  # the run goes on without the backend, as JAX's
            logging.info(f"TensorBoard is not written: {type(e).__name__}: {e}")
    if log_wandb:
        try:
            import wandb

            wandb.init(dir=out_dir, resume="allow")
            _writers.append(("wandb", wandb))
        except Exception as e:  # noqa: BLE001
            logging.info(f"wandb is not written: {type(e).__name__}: {e}")


def writes_images():
    """True where a backend that takes images and histograms is set up
    (TensorBoard; JAX's writer sends wandb scalars only, and the JSONL log
    holds scalars only)."""
    return any(kind == "tb" for kind, _ in _writers)


def put_scalar(name, scalar, step=None):
    _EVENT_STORAGE.append({"type": "scalar", "name": name, "value": _to_py(scalar), "step": step})


def put_scalar_dict(name, scalar, step=None):
    for key, val in scalar.items():
        put_scalar(f"{name}/{key}", val, step=step)


def put_scalar_list(name, scalars, step=None):
    for i, val in enumerate(scalars):
        put_scalar(f"{name}/{i}", val, step=step)


def put_tensor(name, tensor, step=None):
    _EVENT_STORAGE.append({"type": "image", "name": name, "value": _to_np(tensor), "step": step})


def put_histogram(name, values, step=None):
    _EVENT_STORAGE.append({"type": "histogram", "name": name, "value": _to_np(values), "step": step})


def put_time(name, duration, step=None, avg_over_steps=True, update_eta=False, max_iterations=None):
    """Record a duration; with ``avg_over_steps`` also the running average

    (reference: writer.py:303-329)."""
    d = _durations[name]
    d["total"] += duration
    d["count"] += 1
    put_scalar(name, duration, step=step)
    if avg_over_steps:
        put_scalar(f"{name}_avg", d["total"] / d["count"], step=step)
    if update_eta and max_iterations is not None and step is not None:
        remaining = max_iterations - step
        put_scalar(f"{name}_eta_min", remaining * (d["total"] / d["count"]) / 60, step=step)


def write_out_storage():
    """Flush the buffered events to every backend (reference: writer.py:331-378)."""
    global _EVENT_STORAGE
    events, _EVENT_STORAGE = _EVENT_STORAGE, []
    if not events:
        return

    if _jsonl_path is not None:
        with open(_jsonl_path, "a") as f:
            for e in events:
                if e["type"] == "scalar":
                    f.write(json.dumps(e) + "\n")

    for kind, w in _writers:
        for e in events:
            if kind == "tb":
                if e["type"] == "scalar" and e["value"] is not None:
                    w.add_scalar(e["name"], e["value"], global_step=e["step"])
                elif e["type"] == "image":
                    w.add_image(e["name"], e["value"], global_step=e["step"], dataformats="HWC")
                elif e["type"] == "histogram":
                    w.add_histogram(e["name"], e["value"], global_step=e["step"])
            elif kind == "wandb" and e["type"] == "scalar":
                w.log({e["name"]: e["value"]}, step=e["step"])
        if kind == "tb":
            w.flush()


def _to_py(x):
    if hasattr(x, "item"):
        try:
            return float(x.item())
        except (TypeError, ValueError, RuntimeError):  # not a one-element value
            return None
    if isinstance(x, (int, float, np.floating, np.integer)):
        return float(x)
    return None


def _to_np(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TensorBoardFile:
    """One TensorBoard event file in ``log_dir``, written as
    ``torch.utils.tensorboard.SummaryWriter`` writes it (see the module
    docstring); ``add_scalar``, ``add_image`` (HWC uint8), ``add_histogram``,
    ``flush`` and ``close`` as its methods of those names."""

    def __init__(self, log_dir):
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import HistogramProto, Summary
        from tensorboard.summary.writer.record_writer import RecordWriter

        self._event, self._summary, self._histogram = Event, Summary, HistogramProto
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}.{os.getpid()}."
                f"{next(_file_ids)}")
        self._records = RecordWriter(open(os.path.join(log_dir, name), "wb"))
        self._write(Event(wall_time=time.time(), file_version="brain.Event:2"))
        self._records.flush()

    def _write(self, event):
        self._records.write(event.SerializeToString())

    def _add(self, value, global_step):
        self._write(self._event(wall_time=time.time(), step=global_step or 0,
                                summary=self._summary(value=[value])))

    def add_scalar(self, tag, value, global_step=None):
        self._add(self._summary.Value(tag=tag, simple_value=float(value)), global_step)

    def add_image(self, tag, img, global_step=None, dataformats="HWC"):
        from PIL import Image

        assert dataformats == "HWC" and img.dtype == np.uint8, (dataformats, img.dtype)
        png = io.BytesIO()
        Image.fromarray(img).save(png, format="PNG")
        height, width, channels = img.shape
        image = self._summary.Image(height=height, width=width, colorspace=channels,
                                    encoded_image_string=png.getvalue())
        self._add(self._summary.Value(tag=tag, image=image), global_step)

    def add_histogram(self, tag, values, global_step=None):
        """Over SummaryWriter's default bins ("tensorflow": +-1e-12 x 1.1^k up
        to 1e20, and 0), the empty bins outside the support cut as its
        ``make_histogram`` cuts them."""
        values = np.asarray(values, dtype=float).reshape(-1)
        counts, limits = np.histogram(values, bins=_DEFAULT_BINS)
        support = np.flatnonzero(counts)
        start, end = int(support[0]), int(support[-1]) + 1
        counts = counts[start - 1:end] if start > 0 else np.concatenate([[0], counts[:end]])
        limits = limits[start:end + 1]
        histogram = self._histogram(min=values.min(), max=values.max(), num=len(values), sum=values.sum(),
                                    sum_squares=values.dot(values), bucket_limit=limits.tolist(),
                                    bucket=counts.tolist())
        self._add(self._summary.Value(tag=tag, histo=histogram), global_step)

    def flush(self):
        self._records.flush()

    def close(self):
        self._records.close()


def _default_bins():
    buckets, v = [], 1e-12
    while v < 1e20:
        buckets.append(v)
        v *= 1.1
    return [-b for b in reversed(buckets)] + [0] + buckets


_DEFAULT_BINS = _default_bins()


class TimeWriter:
    """Context manager timing a block on the host clock (reference:
    writer.py:303-329). On a card the block's time is what the host spent
    in it: launches return before the device has run them."""

    def __init__(self, name, step=None, write=True, avg_over_steps=True, update_eta=False, max_iterations=None):
        self.name = name
        self.step = step
        self.write = write
        self.avg_over_steps = avg_over_steps
        self.update_eta = update_eta
        self.max_iterations = max_iterations

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *args):
        self.duration = time.time() - self.start
        if self.write:
            put_time(self.name, self.duration, step=self.step, avg_over_steps=self.avg_over_steps,
                     update_eta=self.update_eta, max_iterations=self.max_iterations)
