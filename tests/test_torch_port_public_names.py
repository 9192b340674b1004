"""The JAX package's public names in the port, and each ported helper against JAX's.

- For each ``.py`` module of ``robustmvd_tpu/`` outside ``ops/pallas/``,
  its top-level public names, read with ``ast`` (no JAX import): functions,
  classes and assigned names, and in a package's ``__init__.py`` also the
  names it imports; nothing under ``if __name__ == "__main__":``. Each is
  importable from the port's counterpart module (the same path under
  ``robustmvd_tpu_torch/``; ``utils/utils_misc.py`` is ``utils/misc.py``),
  or stands in ``JAX_ONLY`` with the reason; an entry of ``JAX_ONLY`` that
  the JAX module lacks or the port has is stale and fails its module's case.
- One CPU case per ported helper: JAX's function and the port's on the same
  seeded numpy inputs (channel-last for JAX, NCHW for the port), exact for
  index and pose algebra, resizes, activations and the smooth L1; 1e-6
  (absolute, values of order 1) for ``warp`` / ``grid_sample_normalized``
  and ``relu_and_sigmoid`` in float32; the DispNet blocks (JAX's flax names
  in the port) with bridged weights at 1e-5 of the output's scale (the
  convolutions' sum order).
"""

import ast
import contextlib
import importlib
import io
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustmvd_tpu
from robustmvd_tpu.loss.mvsnet_sl1 import smooth_l1 as jax_smooth_l1
from robustmvd_tpu.models.blocks import dispnet as jax_dispnet
from robustmvd_tpu.ops.interpolate import resize_nearest as jax_resize_nearest
from robustmvd_tpu.ops.sampling import grid_sample_normalized as jax_grid_sample_normalized
from robustmvd_tpu.ops.sampling import warp as jax_warp
from robustmvd_tpu.utils import conversion as jax_conversion
from robustmvd_tpu.utils import geometry as jax_geometry
from robustmvd_tpu.utils import logging as jax_logging
from robustmvd_tpu.utils import utils_misc as jax_misc
from robustmvd_tpu_torch.loss.mvsnet_sl1 import smooth_l1
from robustmvd_tpu_torch.models.blocks import dispnet
from robustmvd_tpu_torch.models.vis_mvsnet import VisMvsnet, VisMVSNet
from robustmvd_tpu_torch.models.weights import state_dict_from_jax
from robustmvd_tpu_torch.ops import grid_sample_normalized, resize_nearest, warp
from robustmvd_tpu_torch.utils import conversion, geometry
from robustmvd_tpu_torch.utils import logging as port_logging
from robustmvd_tpu_torch.utils import misc

from torch_port_helpers import random_pose, relative_errors, t

JAX_ROOT = Path(robustmvd_tpu.__file__).parent
COUNTERPART = {"utils/utils_misc.py": "utils/misc.py"}

_FLAX_MODULE = "a flax module; the port's counterpart is its nn.Module model class"
_TORCH_DECONV = "a flax module that computes torch's transposed convolution; the port uses torch's own"
_TPU_CONV3D = ("a TPU reformulation of the 3x3x3 convolution (ROADMAP north star); the port's 3D convolutions "
               "are cuDNN's or K5 (ops/conv3d.py::Conv3d)")
_TORCH_TO_FLAX = "a torch -> flax converter; the port loads torch checkpoints as they are"
_KAIMING = "a flax initializer; the port's counterpart is models/blocks/dispnet.py::init_weights"
JAX_ONLY = {
    "utils/native.py": {"*": "builds and loads the JAX package's C++ host reader (robustmvd_tpu/native/)"},
    "utils/platform.py": {"*": "selects JAX's backend and its compilation cache"},
    "utils/conversion.py": {"to_jax": "numpy -> jax arrays; the port's inputs become tensors in its adapters"},
    "utils/__init__.py": {"to_jax": "see utils/conversion.py"},
    "parallel/context.py": {"constrain": "a JAX sharding constraint; the port shards by rank (parallel/context.py)"},
    "optim/factory.py": {"build_optax": "builds an optax transformation; the port's optimizers are torch's"},
    "optim/optims.py": {"OptimizerSpec": "optax's optimizer description; the port builds torch optimizers",
                        "SchedulerSpec": "optax's schedule description; the port builds torch schedulers"},
    "ops/conv3d.py": {name: _TPU_CONV3D for name in (
        "Conv3dDz2d", "Conv3dPacked", "Conv3dPackedS2", "conv3d_dz2d", "conv3d_packed", "conv3d_packed_s2",
        "conv3d_transposed_dz2d", "conv3d_op")},
    "models/weights.py": {name: _TORCH_TO_FLAX for name in (
        "convert_torch_checkpoint", "convert_torch_state_dict", "convert_vis_mvsnet_torch_state_dict")},
    "models/robust_mvd.py": {"RobustMVDModule": _FLAX_MODULE, "kaiming_leaky": _KAIMING},
    "models/mvsnet.py": {"MVSNetModule": _FLAX_MODULE},
    "models/cvp_mvsnet.py": {"CVPMVSNetModule": _FLAX_MODULE},
    "models/vis_mvsnet.py": {"VisMvsnetModule": _FLAX_MODULE},
    "models/blocks/dispnet.py": {"TorchConvTranspose": _TORCH_DECONV, "kaiming_leaky": _KAIMING},
    "models/blocks/mvsnet.py": {"TorchConvTranspose3d": _TORCH_DECONV},
    "models/blocks/vis_mvsnet.py": {"TorchDeconv": _TORCH_DECONV},
    "models/blocks/cvp_mvsnet.py": {"conv_lrelu01": "a flax helper that names its conv in the caller's scope; the "
                                                    "port's FeaturePyramid holds its convs and applies LeakyReLU(0.1)"},
}


def _is_main_guard(node):
    return (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
            and isinstance(node.test.left, ast.Name) and node.test.left.id == "__name__")


def public_names(path):
    """A module's top-level public names, read from its source."""
    package = path.name == "__init__.py"
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names.update(n.id for target in targets for n in ast.walk(target) if isinstance(n, ast.Name))
            elif package and isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)) and not _is_main_guard(node):
                visit(node.body)
                visit(node.orelse)
                for handler in getattr(node, "handlers", []):
                    visit(handler.body)

    visit(ast.parse(path.read_text()).body)
    return {n for n in names if not n.startswith("_") and n != "*"}


MODULES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py")
                 if p.relative_to(JAX_ROOT).parts[:2] != ("ops", "pallas"))


def test_the_jax_only_list_names_jax_modules():
    assert set(JAX_ONLY) <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    names = public_names(JAX_ROOT / module)
    jax_only = JAX_ONLY.get(module, {})
    if "*" in jax_only:
        port_path = Path(robustmvd_tpu.__file__).parents[1] / "robustmvd_tpu_torch" / module
        assert not port_path.exists(), f"{module} is listed as JAX-only but the port has it"
        return
    assert set(jax_only) <= names, f"JAX_ONLY names {set(jax_only) - names} that {module} does not define"
    rel = Path(COUNTERPART.get(module, module)).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    port = importlib.import_module(".".join(("robustmvd_tpu_torch",) + parts))
    missing = sorted(n for n in names - set(jax_only) if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing} of {module}"
    stale = sorted(n for n in jax_only if hasattr(port, n))
    assert not stale, f"JAX_ONLY lists {stale} of {module}, which {port.__name__} has"


# --- the ported helpers against JAX's ------------------------------------------

def case_rebase_poses_to_key():
    rng = np.random.RandomState(0)
    poses = [random_pose(rng, scale=0.3) for _ in range(4)]
    for key in (0, 2):
        for ours, ref in zip(geometry.rebase_poses_to_key(poses, key), jax_geometry.rebase_poses_to_key(poses, key)):
            assert ours.dtype == ref.dtype == np.float32 and np.array_equal(ours, ref)


def case_from_relative_intrinsics():
    K = np.random.RandomState(1).rand(2, 3, 3).astype(np.float32)
    ours, ref = geometry.from_relative_intrinsics(K, 320, 256), jax_geometry.from_relative_intrinsics(K, 320, 256)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert np.allclose(geometry.to_relative_intrinsics(ours, 320, 256), K, rtol=1e-6)


def case_trans_and_rot_from_transform():
    T = np.stack([random_pose(np.random.RandomState(i)) for i in range(3)])
    for ours, ref in ((geometry.trans_from_transform(T), jax_geometry.trans_from_transform(T)),
                      (geometry.rot_from_transform(T), jax_geometry.rot_from_transform(T)),
                      (geometry.trans_from_transform(T[0]), jax_geometry.trans_from_transform(T[0]))):
        assert ours.shape == ref.shape and np.array_equal(ours, ref)


def case_normalize():
    x = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    for axis in (None, 0, -1):
        assert np.array_equal(geometry.normalize(x, axis=axis), jax_geometry.normalize(x, axis=axis))


def case_batched_index():
    views = [np.array([3, 1, 4]), np.array([1, 5, 9]), np.array([2, 6, 5])]
    elements = [1, 5, 5]
    assert np.array_equal(conversion.batched_index(views, elements), jax_conversion.batched_index(views, elements))


def case_set_random_seed():
    draws = []
    for fn in (jax_misc.set_random_seed, misc.set_random_seed):
        fn(7)
        draws.append((random.random(), np.random.rand(3), torch.rand(3)))
    (a, b, c), (x, y, z) = draws
    assert a == x and np.array_equal(b, y) and torch.equal(c, z)


def case_check_finite():
    good, bad = np.ones(3, np.float32), np.array([1.0, np.nan], np.float32)
    jax_misc.check_finite("x", good, good)
    misc.check_finite("x", good, torch.from_numpy(good))
    with pytest.raises(jax_misc.NanError) as ref:
        jax_misc.check_finite("x", good, bad)
    for arr in (bad, torch.from_numpy(bad), torch.tensor([1.0, float("inf")])):
        with pytest.raises(misc.NanError) as ours:
            misc.check_finite("x", good, arr)
        assert str(ours.value) == str(ref.value) == "x[1] contains non-finite values"


def case_lookups_by_name():
    for name in ("os.path.join", "numpy.linalg.norm", "collections.OrderedDict", "no_such_module_xyz.f",
                 "os.no_such_function", "no_such_package.sub.f"):
        for fn in ("module_exists", "function_exists", "class_exists"):
            arg = name.rsplit(".", 1)[0] if fn == "module_exists" else name
            assert getattr(misc, fn)(arg) == getattr(jax_misc, fn)(arg), (fn, arg)
        if jax_misc.function_exists(name):
            assert misc.get_function(name) is jax_misc.get_function(name) is misc.get_class(name)


def case_logging():
    def lines(module):
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                module.set_level("debug")
                module.debug("d", 1)
                module.warning("w")
                module.error("e", 2.5)
                module.set_level("error")
                module.info("hidden")
                module.warning("hidden")
                module.error("shown")
                assert module.logger.level == 40
        finally:
            module.set_level("info")
        return [re.sub(r"^\[[^]]*\] ", "", line) for line in out.getvalue().splitlines()]

    ours = lines(port_logging)
    assert ours == lines(jax_logging)
    assert ours == ["[DEBUG] d 1", "[WARNING] w", "[ERROR] e 2.5", "[ERROR] shown"]


def _grid_inputs(seed):
    rng = np.random.RandomState(seed)
    img = rng.randn(2, 9, 11, 3).astype(np.float32)  # channel-last, as JAX takes it
    grid = np.stack([rng.uniform(-2, 12, (2, 4, 5)), rng.uniform(-2, 10, (2, 4, 5))], -1).astype(np.float32)
    return img, grid


def case_warp():
    img, grid = _grid_inputs(3)
    for padding_mode in ("zeros", "border"):
        ref, ref_mask = jax_warp(jnp.asarray(img), jnp.asarray(grid), padding_mode)
        ours, mask = warp(t(img).permute(0, 3, 1, 2), t(grid), padding_mode)
        assert ours.shape == (2, 3, 4, 5) and mask.shape == (2, 4, 5)
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
        assert padding_mode == "border" or 0 < mask.numpy().mean() < 1  # both sides of the edge


def case_grid_sample_normalized():
    img, grid = _grid_inputs(4)
    grid_n = grid / np.array([11, 9], np.float32) * 2 - 1
    for padding_mode in ("zeros", "border"):
        ref = jax_grid_sample_normalized(jnp.asarray(img), jnp.asarray(grid_n), padding_mode)
        ours = grid_sample_normalized(t(img).permute(0, 3, 1, 2), t(grid_n), padding_mode)
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=0, atol=1e-6)
        library = torch.nn.functional.grid_sample(t(img).permute(0, 3, 1, 2), t(grid_n), padding_mode=padding_mode,
                                                  align_corners=False)
        np.testing.assert_allclose(ours.numpy(), library.numpy(), rtol=0, atol=1e-5)


def case_resize_nearest():
    x = np.random.RandomState(5).randn(2, 7, 9, 3).astype(np.float32)
    for size in ((4, 13), (15, 5), (7, 9), (3, 3)):
        ref = np.asarray(jax_resize_nearest(jnp.asarray(x), size))
        ours = resize_nearest(t(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(ours, ref)


def case_smooth_l1():
    x = np.concatenate([np.random.RandomState(6).randn(200) * 2, [0.0, 1.0, -1.0, 0.999, -1.001]]).astype(np.float32)
    np.testing.assert_array_equal(smooth_l1(t(x)).numpy(), np.asarray(jax_smooth_l1(jnp.asarray(x))))


def case_leaky_relu():
    x = np.random.RandomState(7).randn(2, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(dispnet.leaky_relu(t(x)).numpy(), np.asarray(jax_dispnet.leaky_relu(x)))


def case_relu_and_sigmoid():
    x = (np.random.RandomState(8).randn(2, 5, 6, 2) * 8).astype(np.float32)
    ref = np.asarray(jax_dispnet.relu_and_sigmoid(jnp.asarray(x), -3.0, 5.0))
    ours = dispnet.relu_and_sigmoid(t(x).permute(0, 3, 1, 2), -3.0, 5.0).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def _block_case(jax_block, port_block, in_ch, deconv=False):
    x = np.random.RandomState(9).randn(1, 8, 12, in_ch).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax_block.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables["params"]["conv"]["bias"] = np.random.RandomState(10).randn(
        *variables["params"]["conv"]["bias"].shape).astype(np.float32) * 0.1
    prefix = "deconv" if deconv else "block"  # the bridge takes a module path starting "deconv" as transposed
    state = state_dict_from_jax({"params": {prefix: variables["params"]}})
    port_block.load_state_dict({k.removeprefix(prefix + "."): v for k, v in state.items()}, strict=True)
    ref = np.asarray(jax_block.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        ours = port_block(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape
    assert relative_errors(ours, ref)[1] <= 1e-5


CASES = {
    "rebase_poses_to_key": case_rebase_poses_to_key,
    "from_relative_intrinsics": case_from_relative_intrinsics,
    "trans_and_rot_from_transform": case_trans_and_rot_from_transform,
    "normalize": case_normalize,
    "batched_index": case_batched_index,
    "set_random_seed": case_set_random_seed,
    "check_finite": case_check_finite,
    "lookups_by_name": case_lookups_by_name,
    "logging": case_logging,
    "warp": case_warp,
    "grid_sample_normalized": case_grid_sample_normalized,
    "resize_nearest": case_resize_nearest,
    "smooth_l1": case_smooth_l1,
    "leaky_relu": case_leaky_relu,
    "relu_and_sigmoid": case_relu_and_sigmoid,
    "ConvLReLU": lambda: _block_case(jax_dispnet.ConvLReLU(8, 3, 2), dispnet.ConvLReLU(4, 8, 3, 2), 4),
    "DeconvLReLU": lambda: _block_case(jax_dispnet.DeconvLReLU(6), dispnet.DeconvLReLU(4, 6), 4, deconv=True),
    "IConvBlock": lambda: _block_case(jax_dispnet.IConvBlock(5), dispnet.IConvBlock(4, 5), 4),
    "PredBlock": lambda: _block_case(jax_dispnet.PredBlock(), dispnet.PredBlock(4), 4),
    "VisMvsnet": lambda: VisMvsnet is VisMVSNet or pytest.fail("VisMvsnet is not VisMVSNet"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ported_helper_matches_jax(name):
    CASES[name]()
