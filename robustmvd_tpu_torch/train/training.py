"""Training base class (reference: rmvd/train/training.py:4-17): the marker
that training engines derive from."""


class Training:
    """Marker base class of training engines."""

    def __call__(self, *args, **kwargs):
        raise NotImplementedError
