"""Matplotlib grid viewer (reference: rmvd/viewer/viewer.py:14-91 and
viewer_controls.py; the JAX package's ``viewer/viewer.py``): previous / next
with the arrow keys (or p / n) in a window; without a display, one PNG page
per sample."""

from __future__ import annotations

import os

import numpy as np

from ..utils.vis import colormap_2d
from .viewer_model import ViewerModel


class Viewer:
    def __init__(self, dataset, layout=None):
        self.model = ViewerModel(dataset, layout)
        self.index = 0

    def _render(self, fig, index):
        fig.clf()
        cells = self.model[index]
        if not cells:
            return
        max_col = max(v.col + v.colspan for v, _ in cells)
        max_row = max(v.row + v.rowspan for v, _ in cells)
        gs = fig.add_gridspec(max_row, max_col)

        for viz, data in cells:
            ax = fig.add_subplot(gs[viz.row:viz.row + viz.rowspan, viz.col:viz.col + viz.colspan])
            ax.set_title(viz.name or "", fontsize=8)
            ax.axis("off")
            arr = data.get("data")
            if arr is None:
                ax.text(0.5, 0.5, data.get("error", "n/a"), fontsize=6, ha="center")
                continue
            arr = np.asarray(arr)
            if data.get("kind") == "image" or (arr.ndim == 3 and arr.shape[-1] == 3 and arr.dtype == np.uint8):
                ax.imshow(arr)
            else:
                if arr.ndim == 3 and arr.shape[-1] == 1:
                    arr = arr[..., 0]
                ax.imshow(colormap_2d(arr))
        fig.suptitle(f"sample {index} / {len(self.model) - 1}", fontsize=10)

    def show(self):
        """A window with left / right navigation."""
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(14, 8))

        def on_key(event):
            if event.key in ("right", "n"):
                self.index = min(self.index + 1, len(self.model) - 1)
            elif event.key in ("left", "p"):
                self.index = max(self.index - 1, 0)
            else:
                return
            self._render(fig, self.index)
            fig.canvas.draw_idle()

        fig.canvas.mpl_connect("key_press_event", on_key)
        self._render(fig, self.index)
        plt.show()

    def export(self, out_dir, indices=None):
        """Write ``sample_{index:07d}.png`` for each sample (all by default)
        into ``out_dir``, without a display; returns the paths."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(out_dir, exist_ok=True)
        indices = indices if indices is not None else range(len(self.model))
        paths = []
        for i in indices:
            fig = plt.figure(figsize=(14, 8))
            self._render(fig, i)
            path = os.path.join(out_dir, f"sample_{i:07d}.png")
            fig.savefig(path, dpi=100, bbox_inches="tight")
            plt.close(fig)
            paths.append(path)
        return paths


def run_viewer(dataset, layout=None, export_dir=None, indices=None):
    """Start the viewer (reference: rmvd/viewer/__init__.py:1-13): a window
    where a display is available, else (or with ``export_dir``) PNG pages in
    ``export_dir`` (``./viewer_out`` by default)."""
    viewer = Viewer(dataset, layout)
    if export_dir is not None or not os.environ.get("DISPLAY"):
        return viewer.export(export_dir or "./viewer_out", indices)
    viewer.show()
    return viewer
