"""Viewer layouts: grid descriptions of per-sample visualizations

(reference: rmvd/data/layout.py:30-81). A Layout is a named list of
Visualizations, each with a grid cell, a visualization type and a
``load_fct`` mapping a sample dict to display data. The port's load
functions are module-level functions or ``functools.partial`` of them, so a
layout pickles with the standard library.
"""

from __future__ import annotations

import pickle


class Visualization:
    def __init__(self, col, row, visualization_type, load_fct, name=None, colspan=1, rowspan=1):
        self.col = col
        self.row = row
        self.visualization_type = visualization_type
        self.load_fct = load_fct
        self.name = name
        self.colspan = colspan
        self.rowspan = rowspan


class Layout:
    def __init__(self, name, visualizations=None):
        self.name = name
        self.visualizations = [] if visualizations is None else visualizations

    def load(self, data):
        return [v.load_fct(data) for v in self.visualizations]

    def write(self, path):
        path = path if path.endswith(".pickle") else path + ".pickle"
        with open(path, "wb") as f:
            pickle.dump(self.visualizations + [self.name], f)

    @classmethod
    def from_file(cls, path, name=None):
        path = path if path.endswith(".pickle") else path + ".pickle"
        with open(path, "rb") as f:
            visualizations = pickle.load(f)
        name = name if name is not None else visualizations[-1]
        return cls(name=name, visualizations=visualizations[:-1])
