"""Viewer model: dataset + layout -> per-cell display data (reference:
rmvd/viewer/viewer_model.py; the JAX package's ``viewer/viewer_model.py``)."""

from __future__ import annotations


def default_layout_name(dataset):
    """The first layout whose name starts with "eval", else "default"."""
    eval_layouts = [n for n in dataset.get_layout_names() if n.startswith("eval")]
    return eval_layouts[0] if eval_layouts else "default"


class ViewerModel:
    def __init__(self, dataset, layout=None):
        self.dataset = dataset
        if layout is None:
            layout = default_layout_name(dataset)
        if isinstance(layout, str):
            layout = dataset.get_layout(layout)
        self.layout = layout

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        """The (visualization, display data) cells of sample ``index``. A cell
        whose load function raises shows the error and leaves the page
        standing, as in the JAX viewer."""
        sample = self.dataset[index]
        cells = []
        for viz in self.layout.visualizations:
            try:
                data = viz.load_fct(sample)
            except Exception as e:  # noqa: BLE001  (shown in its cell)
                data = {"data": None, "kind": "error", "error": f"{type(e).__name__}: {e}"}
            cells.append((viz, data))
        return cells
