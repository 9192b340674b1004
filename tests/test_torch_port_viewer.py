"""The port's viewer (``viewer/``, ``run_viewer``, ``python -m
robustmvd_tpu_torch.viewer``) vs the JAX package's.

``ViewerModel`` resolves the same layout of ``synthetic.train.mvd`` into the
same cells as JAX's: names, grid positions, kinds and data arrays equal. The
CLI with ``--export_dir`` writes one PNG page per sample, headless, as the JAX
package's ``data_viewer.py`` does; ``run_viewer`` of the facade exports the
pages it is asked for.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import robustmvd_tpu
from robustmvd_tpu.viewer import ViewerModel as JaxViewerModel
import robustmvd_tpu_torch
from robustmvd_tpu_torch.viewer import ViewerModel

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("layout", [None, "default"])
def test_viewer_model_cells_equal_jax(layout):
    kwargs = dict(num_samples=2, num_views=3, height=32, width=48)
    ours = ViewerModel(robustmvd_tpu_torch.create_dataset("synthetic.train.mvd", **kwargs), layout)
    ref = JaxViewerModel(robustmvd_tpu.create_dataset("synthetic.train.mvd", **kwargs), layout)
    assert len(ours) == len(ref) == 2 and ours.layout.name == ref.layout.name
    for index in range(2):
        cells, ref_cells = ours[index], ref[index]
        assert len(cells) == len(ref_cells) > 0
        for (viz, data), (ref_viz, ref_data) in zip(cells, ref_cells):
            assert (viz.name, viz.col, viz.row, viz.colspan, viz.rowspan) == (
                ref_viz.name, ref_viz.col, ref_viz.row, ref_viz.colspan, ref_viz.rowspan)
            assert data.keys() == ref_data.keys() and data.get("kind") == ref_data.get("kind")
            np.testing.assert_array_equal(data["data"], ref_data["data"], err_msg=viz.name)


def test_viewer_cli_exports_one_page_per_sample(tmp_path):
    out = subprocess.run([sys.executable, "-m", "robustmvd_tpu_torch.viewer", "synthetic.train.mvd", "--export_dir",
                          str(tmp_path)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    pages = sorted(p.name for p in tmp_path.iterdir())
    assert pages == [f"sample_{i:07d}.png" for i in range(16)]  # synthetic.train.mvd's 16 samples
    page = np.array(Image.open(tmp_path / pages[0]))
    assert page.ndim == 3 and page.shape[0] > 100 and page.std() > 0


def test_facade_run_viewer_exports(tmp_path):
    dataset = robustmvd_tpu_torch.create_dataset("synthetic.train.mvd", num_samples=3, height=32, width=48)
    paths = robustmvd_tpu_torch.run_viewer(dataset, export_dir=str(tmp_path), indices=[2])
    assert paths == [str(tmp_path / "sample_0000002.png")] and Path(paths[0]).is_file()


def test_facade_has_every_name_of_the_jax_facade():
    names = {n for n in dir(robustmvd_tpu) if not n.startswith("_") and callable(getattr(robustmvd_tpu, n))}
    assert len(names) == 30 and names <= set(dir(robustmvd_tpu_torch)), sorted(names - set(dir(robustmvd_tpu_torch)))
