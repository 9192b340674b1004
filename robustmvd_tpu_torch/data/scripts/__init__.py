"""The data scripts: converters of the raw dataset downloads into the layouts
that the readers take, the generator of ``sample_data/``, and the download
scripts. Each converter runs as ``python -m
robustmvd_tpu_torch.data.scripts.<name> IN_PATH OUT_PATH``; they need numpy
(and PIL for ScanNet and the sample data), not torch."""
