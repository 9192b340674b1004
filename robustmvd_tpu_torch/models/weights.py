"""Weights in and out of the port: rmvd checkpoints and JAX parameter trees.

The port's modules carry the rmvd torch parameter names and layouts, so a
rmvd checkpoint (``{"model_state_dict": ...}``, optionally with
``module.`` prefixes, rmvd/models/helpers.py:132-154) loads directly.

:func:`state_dict_from_jax` is the inverse of the JAX package's
``convert_torch_state_dict``: it turns that package's parameter tree (a
nested dict of numpy arrays) into the port's ``state_dict``:

flax path                                   -> torch name
encoder/conv1/conv/{kernel,bias}            -> encoder.conv1.0.{weight,bias}
fusion_block/corr_to_view_weight_conv0/*    -> fusion_block.corr_to_view_weight.0.*
fusion_block/corr_to_view_weight_conv1/*    -> fusion_block.corr_to_view_weight.2.*
decoder/deconv_1/conv/kernel                -> decoder.deconv_1.0.weight

Conv kernels (kh, kw, I, O) become (O, I, kh, kw); ConvTranspose kernels
are stored spatially flipped as (kh, kw, I, O) and become (I, O, kh, kw).
"""

from __future__ import annotations

import numpy as np
import torch

_SEQ_NAMES = {"corr_to_view_weight_conv0": "corr_to_view_weight.0",
              "corr_to_view_weight_conv1": "corr_to_view_weight.2"}


def load_checkpoint(path):
    """A rmvd ``.pt`` checkpoint -> the port's state_dict (on the CPU)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in state:
        state = state["model_state_dict"]
    return {k.replace("module.", "", 1) if k.startswith("module.") else k: v for k, v in state.items()}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_jax(variables):
    """JAX parameters (``{"params": {...}}`` or the params tree) -> state_dict."""
    params = variables.get("params", variables)
    state = {}
    for path, value in _flatten(params):
        *parts, leaf = path
        is_deconv = any(p.startswith("deconv") for p in parts)
        parts = [_SEQ_NAMES.get(p, "0" if p == "conv" else p) for p in parts]
        w = np.asarray(value)
        if leaf == "kernel":
            if is_deconv:
                w = w[::-1, ::-1].transpose(2, 3, 0, 1)  # flipped (kh,kw,I,O) -> (I,O,kh,kw)
            else:
                w = w.transpose(3, 2, 0, 1)  # (kh,kw,I,O) -> (O,I,kh,kw)
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        state[".".join(parts + [leaf])] = torch.from_numpy(np.array(w, dtype=np.float32))
    return state
