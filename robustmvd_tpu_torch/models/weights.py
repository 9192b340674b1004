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

The MVSNet family's trees (``{"params", "batch_stats"}``) keep the flax
module names, which the port's modules carry too:

flax path                                   -> torch name
params/feature/conv0/conv/kernel            -> feature.conv0.conv.weight
params/feature/conv0/bn/{scale,bias}        -> feature.conv0.bn.{weight,bias}
batch_stats/feature/conv0/bn/{mean,var}     -> feature.conv0.bn.running_{mean,var}
params/cost_regularization/prob/*           -> cost_regularization.prob.*

3D kernels (kd, kh, kw, I, O) become (O, I, kd, kh, kw). The transposed
convolutions (MVSNet's ``conv7/conv9/conv11.conv``, and every module named
``*_deconv``: CVP-MVSNet's 3D ones, Vis-MVSNet's 2D and 3D ``TorchDeconv``)
run in JAX as a correlation of the dilated input with the kernel as stored;
torch's ConvTranspose correlates with its weight flipped, so (k..., I, O)
becomes (I, O, k...) flipped on every spatial axis (matched on the module
path's end, so that a lone block's tree converts too). BatchNorms are the
modules named ``bn``, ``bnN`` or ``*_bn``; every one gets
``num_batches_tracked = 0``. :func:`variables_from_state_dict` is the
inverse.

Vis-MVSNet checkpoints in rmvd naming (its UNet registry,
rmvd/models/blocks/vis_mvsnet_unet_modular.py, and Sequential stems) load
through :func:`vis_state_dict_from_rmvd`, the rename rules of the JAX
package's ``convert_vis_mvsnet_torch_state_dict``; the weights keep torch's
layouts, which the port's modules share:

rmvd name                                   -> port name
unet.enc_blocks.<tag>_<i>.<j>.*             -> unet.enc_<i>.block<j>.*
unet.dec_blocks.<tag>_<i>.{0,1}.*           -> unet.dec_<i>_{deconv,post}.*
unet.dec_blocks.<tag>_<i>.2.<j>.*           -> unet.dec_<i>_res.block<j>.*
downsample.{0,1}.*                          -> downsample_{conv,bn}.*
init_conv.{0,1}.*                           -> init_{conv,bn}.*
uncert_net.conv<k>.{0,1}.*                  -> uncert_net.conv<k>_{conv,bn}.*
uncert_net.head_convs.<i>.*                 -> uncert_net.head_<i>.*
"""

from __future__ import annotations

import re

import numpy as np
import torch

# MVSNet's CostRegNet transposed 3D convolutions (module path suffixes);
# modules named *_deconv are transposed too
_TRANSPOSED = ("conv7.conv", "conv9.conv", "conv11.conv")
_BN_NAME = re.compile(r"(.*_)?bn\d*")
_BN_LEAVES = {("params", "scale"): "weight", ("params", "bias"): "bias",
              ("batch_stats", "mean"): "running_mean", ("batch_stats", "var"): "running_var"}

_SEQ_NAMES = {"corr_to_view_weight_conv0": "corr_to_view_weight.0",
              "corr_to_view_weight_conv1": "corr_to_view_weight.2"}


# rmvd's Vis-MVSNet names -> the port's, in the JAX converter's order
_VIS_FROM_RMVD = (
    (r"unet\.enc_blocks\.[^.]*_(\d+)\.(\d+)\.", r"unet.enc_\1.block\2."),
    (r"unet\.dec_blocks\.[^.]*_(\d+)\.0\.", r"unet.dec_\1_deconv."),
    (r"unet\.dec_blocks\.[^.]*_(\d+)\.1\.", r"unet.dec_\1_post."),
    (r"unet\.dec_blocks\.[^.]*_(\d+)\.2\.(\d+)\.", r"unet.dec_\1_res.block\2."),
    (r"downsample\.0\.", "downsample_conv."),
    (r"downsample\.1\.", "downsample_bn."),
    (r"init_conv\.0\.", "init_conv."),
    (r"init_conv\.1\.", "init_bn."),
    (r"uncert_net\.conv(\d)\.0\.", r"uncert_net.conv\1_conv."),
    (r"uncert_net\.conv(\d)\.1\.", r"uncert_net.conv\1_bn."),
    (r"uncert_net\.head_convs\.(\d+)\.", r"uncert_net.head_\1."),
)
# the port's names -> rmvd's, with the tags "enc" and "dec"
_VIS_TO_RMVD = (
    (r"unet\.enc_(\d+)\.block(\d+)\.", r"unet.enc_blocks.enc_\1.\2."),
    (r"unet\.dec_(\d+)_deconv\.", r"unet.dec_blocks.dec_\1.0."),
    (r"unet\.dec_(\d+)_post\.", r"unet.dec_blocks.dec_\1.1."),
    (r"unet\.dec_(\d+)_res\.block(\d+)\.", r"unet.dec_blocks.dec_\1.2.\2."),
    (r"downsample_conv\.", "downsample.0."),
    (r"downsample_bn\.", "downsample.1."),
    (r"init_conv\.", "init_conv.0."),
    (r"init_bn\.", "init_conv.1."),
    (r"uncert_net\.conv(\d)_conv\.", r"uncert_net.conv\1.0."),
    (r"uncert_net\.conv(\d)_bn\.", r"uncert_net.conv\1.1."),
    (r"uncert_net\.head_(\d+)\.", r"uncert_net.head_convs.\1."),
)
# the key that tells the namings apart: rmvd's FeatExt stem is a Sequential
# (conv, BN); the port's has the modules init_conv and init_bn
RMVD_VIS_KEY = "feat_ext.init_conv.0.weight"


def _renamed(state, rules):
    out = {}
    for key, value in state.items():
        for pattern, repl in rules:
            key = re.sub(pattern, repl, key)
        out[key] = value
    return out


def vis_state_dict_from_rmvd(state):
    """A Vis-MVSNet state_dict in rmvd naming -> the port's names; a
    port-named one (no ``RMVD_VIS_KEY``) comes back as it is."""
    return _renamed(state, _VIS_FROM_RMVD) if RMVD_VIS_KEY in state else dict(state)


def vis_state_dict_to_rmvd(state):
    """The port's Vis-MVSNet state_dict in rmvd naming (the inverse of
    :func:`vis_state_dict_from_rmvd`)."""
    return _renamed(state, _VIS_TO_RMVD)


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


def _numpy_leaf(value):
    """A leaf as numpy: a tensor (the msgpack reader's bfloat16 leaves)
    through float32, which holds every bfloat16 value exactly."""
    if isinstance(value, torch.Tensor):
        return value.float().numpy()
    return np.asarray(value)


def state_dict_from_jax(variables):
    """JAX variables -> state_dict: ``{"params", "batch_stats"}`` of the

    MVSNet family, or robust_mvd's ``{"params": ...}`` or params tree.
    Leaves become float32 tensors: float32 leaves bit for bit, bfloat16
    ones (numpy's ``ml_dtypes`` arrays or ``torch.bfloat16`` tensors)
    widened exactly."""
    if "batch_stats" in variables:
        return _family_state_dict(variables)
    params = variables.get("params", variables)
    state = {}
    for path, value in _flatten(params):
        *parts, leaf = path
        is_deconv = any(p.startswith("deconv") for p in parts)
        parts = [_SEQ_NAMES.get(p, "0" if p == "conv" else p) for p in parts]
        w = _numpy_leaf(value)
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


def _is_bn(module):
    return _BN_NAME.fullmatch(module.rsplit(".", 1)[-1]) is not None


def _is_transposed(module):
    return module.endswith(_TRANSPOSED) or module.endswith("_deconv")


def _kernel_to_torch(module, w):
    """(k..., I, O) -> (O, I, k...); transposed: flipped, (I, O, k...)."""
    n = w.ndim - 2
    if _is_transposed(module):
        return w[(slice(None, None, -1),) * n].transpose(n, n + 1, *range(n))
    return w.transpose(n + 1, n, *range(n))


def _kernel_to_jax(module, w):
    n = w.ndim - 2
    if _is_transposed(module):
        return w.transpose(*range(2, n + 2), 0, 1)[(slice(None, None, -1),) * n]
    return w.transpose(*range(2, n + 2), 1, 0)


def _family_state_dict(variables):
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables[collection]):
            *parts, leaf = path
            module = ".".join(parts)
            w = _numpy_leaf(value)
            if _is_bn(module):
                name = _BN_LEAVES[(collection, leaf)]
                if name == "weight":
                    state[f"{module}.num_batches_tracked"] = torch.tensor(0)
            elif collection == "params" and leaf == "kernel":
                name, w = "weight", _kernel_to_torch(module, w)
            elif collection == "params" and leaf == "bias":
                name = "bias"
            else:
                raise ValueError(f"unexpected variable {collection}/{'/'.join(path)}")
            state[f"{module}.{name}"] = torch.from_numpy(np.array(w, dtype=np.float32))
    return state


def variables_from_state_dict(state):
    """An MVSNet-family state_dict -> JAX ``{"params", "batch_stats"}``

    (the inverse of :func:`state_dict_from_jax` for those trees)."""
    leaves = {name: key for key, name in _BN_LEAVES.items()}
    variables = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        module, name = key.rsplit(".", 1)
        if name == "num_batches_tracked":
            continue
        w = value.detach().cpu().numpy()
        if name in ("running_mean", "running_var") or (_is_bn(module) and name in ("weight", "bias")):
            collection, leaf = leaves[name]
        elif name == "weight":
            collection, leaf, w = "params", "kernel", _kernel_to_jax(module, w)
        else:
            collection, leaf = "params", name
        node = variables[collection]
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(w)
    return variables
