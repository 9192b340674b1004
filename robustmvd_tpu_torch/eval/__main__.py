"""``python -m robustmvd_tpu_torch.eval``: the evaluation CLI (``cli.py``)."""

from .cli import main

if __name__ == "__main__":
    main()
