"""Dataset viewer (reference: rmvd/viewer/__init__.py:1-13), the JAX package's
``viewer`` in the port.

The reference ships a PyQt5/iviz GUI (rmvd/viewer/viewer.py:14-91); like the
JAX package, the port has a matplotlib viewer with the same layout-driven
structure: a dataset's layout maps a sample to grid cells of
visualisations, :class:`ViewerModel` resolves them, and :class:`Viewer`
draws a page per sample (a window where a display is available, PNG files
otherwise). matplotlib is imported when a page is drawn, not with the
package. Host-only: nothing here touches a card.

    python -m robustmvd_tpu_torch.viewer synthetic.train.mvd --export_dir out/
"""

from .viewer import Viewer, run_viewer
from .viewer_model import ViewerModel

__all__ = ["Viewer", "ViewerModel", "run_viewer"]
