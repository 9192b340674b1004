"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py).

The same numpy inputs go through a function of the JAX package and its
counterpart in ``robustmvd_tpu_torch`` (on the CPU, where each kernel wrapper
runs its plain version); weights made by the JAX package's ``init`` are
carried into the port with ``state_dict_from_jax``.
"""

import contextlib

import numpy as np
import torch

from test_epipolar import random_pose  # noqa: F401  (re-exported for the port tests)

from robustmvd_tpu_torch.models.weights import state_dict_from_jax

K_REL = np.array([[1.1, 0, 0.5], [0, 1.4, 0.5], [0, 0, 1]], dtype=np.float32)


@contextlib.contextmanager
def torch_threads(n):
    """torch's intra-op threads set to ``n`` for the block: the suite runs
    one process per core, and a model of thousands of small ops on all cores
    in each of them spends its time in the thread pools."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def t(a, dtype=None):
    """numpy -> CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


def load_bridged(module, jax_params):
    """Load a JAX parameter tree into a port module (strictly: all keys)."""
    module.load_state_dict(state_dict_from_jax(jax_params), strict=True)
    return module.eval()


def relative_errors(ours, ref):
    """(mean|d|, max|d|) over mean|ref|."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).mean() + 1e-12
    diff = np.abs(ours - ref)
    return diff.mean() / scale, diff.max() / scale


def mvd_sample(rng, H, W, num_views, B=1):
    """A random multi-view sample in the run() contract: images 0..255

    (B, 3, H, W) per view, absolute intrinsics, key->view poses with a
    baseline growing with the view index."""
    images = [rng.rand(B, 3, H, W).astype(np.float32) * 255 for _ in range(num_views)]
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    intrinsics = [np.tile(K, (B, 1, 1)) for _ in range(num_views)]
    poses = [np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))]
    for i in range(1, num_views):
        T = random_pose(rng, scale=0.05)
        T[0, 3] += 0.1 * i
        poses.append(np.tile(T, (B, 1, 1)))
    return {"images": images, "poses": poses, "intrinsics": intrinsics, "keyview_idx": np.zeros(B, np.int64)}


def run_bridged_block(jax_module, port_module, x, rng, name=None):
    """Init a flax block on channel-last ``x``, randomise its variables,
    bridge them into ``port_module`` (under the module path ``name`` where
    the bridge needs the path), and run both: (port output, JAX output),
    the port fed channel-first."""
    import jax
    import jax.numpy as jnp

    variables = randomized_variables(jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    if name is None:
        port_module.load_state_dict(state_dict_from_jax(variables), strict=True)
    else:
        state = state_dict_from_jax({k: {name: v} for k, v in variables.items()})
        torch.nn.ModuleDict({name: port_module}).load_state_dict(state, strict=True)
    port_module.eval()
    ref = np.asarray(jax_module.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = port_module(t(x).permute(0, x.ndim - 1, *range(1, x.ndim - 1))).numpy()
    return out, ref


def randomized_variables(variables, rng, prob_gain=1.0):
    """A flax ``{"params", "batch_stats"}`` tree with BatchNorm statistics,
    scales and every bias drawn at random (init leaves them at the identity
    and zero; any BatchNorm name: ``bn``, ``bn1``, ``conv1_bn``), and the
    score heads' kernels (``prob``/``prob0``, Vis-MVSNet's ``final_conv``)
    scaled by ``prob_gain`` so that the softmax over hypotheses is not nearly
    flat."""
    import jax

    def draw(path, v):
        v = np.asarray(v)
        key = path[-1].key
        if key == "mean" or key == "bias":
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        if key == "var":
            return (0.5 + rng.rand(*v.shape)).astype(np.float32)
        if key == "scale":
            return (0.8 + 0.4 * rng.rand(*v.shape)).astype(np.float32)
        if key == "kernel" and path[-2].key in ("prob", "prob0", "final_conv"):
            return (v * prob_gain).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(draw, jax.tree_util.tree_map(np.asarray, dict(variables)))


def general_mvd_sample(rng, H, W, num_views, B=1):
    """As :func:`mvd_sample` with rotated source cameras and a (1, 10) depth
    range: CVP-MVSNet's hypothesis interval is singular for a pure
    translation without rotation."""
    from scipy.spatial.transform import Rotation

    sample = mvd_sample(rng, H, W, num_views, B)
    for i in range(1, num_views):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
        T[:3, 3] = rng.randn(3) * 0.1 + [0.1 * i, 0.0, 0.0]
        sample["poses"][i] = np.tile(T, (B, 1, 1))
    sample["depth_range"] = (np.full(B, 1.0, np.float32), np.full(B, 10.0, np.float32))
    return sample


# image size of each dataset's fixture (write_benchmark_fixtures)
FIXTURE_IMAGE_SIZES = {"kitti": (24, 80), "dtu": (24, 32), "scannet": (30, 40), "tanks_and_temples": (28, 44),
                       "eth3d": (24, 36)}


def write_benchmark_fixtures(root, rng):
    """Write the files that sample 0 of each of the five ``*.robustmvd.mvd``
    sample lists reads, in each dataset's raw format, under ``root/<base
    dataset>``, with the writers of ``tests/test_dataset_fixtures.py``; return
    the roots by base dataset name. ETH3D's depth is the reader's fixed 4032 x
    6048 raw float32."""
    import os
    import os.path as osp

    from test_dataset_fixtures import _write_jpg, _write_pfm, _write_png

    from robustmvd_tpu_torch.data import create_dataset

    roots = {}
    for name, (H, W) in FIXTURE_IMAGE_SIZES.items():
        sample = create_dataset(f"{name}.robustmvd.mvd", root="/nonexistent", verbose=False).samples[0]
        roots[name] = osp.join(str(root), name)
        base = osp.join(roots[name], getattr(sample, "base", ""))
        for item in sample.data["images"]:
            pixels = (rng.rand(H, W, 3) * 255).astype(np.uint8)
            (_write_png if item.path.endswith(".png") else _write_jpg)(osp.join(base, item.path), pixels)
        depth_path = osp.join(base, sample.data["depth"].path)
        os.makedirs(osp.dirname(depth_path), exist_ok=True)
        if name == "kitti":  # 16-bit PNG, depth * 256, 0 = invalid
            depth = (rng.rand(H, W) * 40 + 2) * 256
            depth[:2] = 0
            _write_png(depth_path, depth.astype(np.uint16))
        elif name == "dtu":  # PFM in mm
            depth = (rng.rand(H, W) * 500 + 400).astype(np.float32)
            depth[:3] = np.nan
            _write_pfm(depth_path, depth)
        elif name == "scannet":  # 16-bit PNG in mm
            depth = (rng.rand(H, W) * 4000 + 500).astype(np.uint16)
            depth[:5] = 0
            _write_png(depth_path, depth)
        elif name == "tanks_and_temples":  # npz
            depth = (rng.rand(H, W) * 5 + 1).astype(np.float32)
            depth[0] = np.nan
            with open(depth_path, "wb") as f:
                np.savez(f, depth)
        else:  # eth3d: raw float32 at the reader's fixed size
            depth = (rng.rand(4032, 6048) * 5 + 1).astype(np.float32)
            depth[:8] = np.nan
            depth[8, :100] = np.inf
            depth.tofile(depth_path)
    return roots


# --- the MVSNet family through both packages ---

def _jax_variables(module, dummy, seed, prob_gain=20.0):
    import jax

    return randomized_variables(jax.jit(module.init)(jax.random.PRNGKey(0), **dummy), np.random.RandomState(seed),
                                prob_gain=prob_gain)


def _dummy(V, with_range=True):
    import jax.numpy as jnp

    d = {"images": jnp.zeros((1, V, 64, 64, 3)), "poses": jnp.tile(jnp.eye(4), (1, V, 1, 1)),
         "intrinsics": jnp.tile(jnp.eye(3) * 32, (1, V, 1, 1)), "keyview_idx": jnp.zeros((1,), jnp.int32)}
    if with_range:
        d["depth_range"] = (jnp.ones((1,)), jnp.full((1,), 10.0))
    else:
        d["min_depth"], d["max_depth"] = jnp.ones((1,)), jnp.full((1,), 10.0)
    return d


def jax_family(name, warp_impl, dtype):
    """(JAX module, randomised variables, input adapter, port kwargs) of a
    family model, the module at ``dtype`` and the variables of its float32
    tree (the same tree: ``tests/test_family_bf16.py:42-47``), initialised
    under ``jax.jit``: mvsnet_train (16 hypotheses) and cvp_mvsnet (nscale 3)
    with score heads x 20, as ``test_torch_port_{mvsnet,cvp}.py`` condition
    them, vis_mvsnet with heads x 4 (``test_torch_port_family_bf16.py``)."""
    from robustmvd_tpu.models.cvp_mvsnet import CVPMVSNet as JaxCVPMVSNet
    from robustmvd_tpu.models.cvp_mvsnet import CVPMVSNetModule
    from robustmvd_tpu.models.mvsnet import MVSNet as JaxMVSNet
    from robustmvd_tpu.models.mvsnet import MVSNetModule
    from robustmvd_tpu.models.vis_mvsnet import VisMvsnet as JaxVisMvsnet
    from robustmvd_tpu.models.vis_mvsnet import VisMvsnetModule

    if name == "mvsnet_train":
        make = lambda dt: MVSNetModule(num_sampling_steps=16, warp_impl=warp_impl, dtype=dt)  # noqa: E731
        variables = _jax_variables(make("float32"), _dummy(2), 3)
        return make(dtype), variables, JaxMVSNet.input_adapter, {"num_sampling_steps": 16}
    if name == "cvp_mvsnet":
        make = lambda dt: CVPMVSNetModule(nscale=3, warp_impl=warp_impl, dtype=dt)  # noqa: E731
        variables = _jax_variables(make("float32"), _dummy(3, with_range=False), 4)
        return make(dtype), variables, JaxCVPMVSNet.input_adapter, {"nscale": 3}
    make = lambda dt: VisMvsnetModule(num_sampling_steps=192, warp_impl=warp_impl, dtype=dt)  # noqa: E731
    variables = _jax_variables(make("float32"), _dummy(2), 3, prob_gain=4.0)
    return make(dtype), variables, JaxVisMvsnet.input_adapter, {}


def run_jax_family(module, variables, adapter, sample):
    """The JAX module's forward under ``jax.jit`` on a run() sample: (pred
    with channel-first float32 maps, aux)."""
    import jax

    inputs = adapter(None, **{k: sample[k] for k in ("images", "keyview_idx", "poses", "intrinsics", "depth_range")})
    inputs.pop("num_views", None)  # every view is real
    pred, aux = jax.jit(module.apply)(variables, **inputs)
    return {k: np.moveaxis(np.asarray(v, np.float32), -1, 1) for k, v in pred.items()}, aux


# image size and sample seed of each model's comparisons (cvp: its float32
# test's sample, where the random model's depth stays in its range)
FAMILY_SAMPLES = {"mvsnet_train": ((64, 80), 5), "cvp_mvsnet": ((64, 128), 6), "vis_mvsnet": ((64, 80), 5)}


def family_sample(name):
    """A 1+2-view sample in the run() contract for a family model."""
    (H, W), seed = FAMILY_SAMPLES[name]
    return general_mvd_sample(np.random.RandomState(seed), H, W, 3)


def assert_depth_within_benchmark_bounds(depth, ref_depth, ref_unc=None, unc=None):
    """A depth scored against a reference depth as ground truth, as the
    benchmark scores it: absrel < 1 point and 1.03-inliers > 97%, the bounds
    JAX holds its bf16 depth to against fp32 (``tests/test_family_bf16.py:
    93-94``); with the uncertainties, their mean |d| <= 1e-2. Returns
    (absrel, inliers)."""
    from robustmvd_tpu.eval.metrics import m_rel_ae, thresh_inliers

    assert depth.shape == ref_depth.shape and depth.dtype == np.float32
    assert np.isfinite(depth).all() and ref_depth.std() > 1e-3 * np.abs(ref_depth).mean()
    ones = np.ones_like(ref_depth)
    absrel = m_rel_ae(gt=ref_depth, pred=depth, mask=ones, output_scaling_factor=100.0)
    inliers = thresh_inliers(gt=ref_depth, pred=depth, thresh=1.03, mask=ones, output_scaling_factor=100.0)
    assert absrel < 1.0 and inliers > 97.0, (absrel, inliers)
    if unc is not None:
        assert np.abs(unc - ref_unc).mean() <= 1e-2, np.abs(unc - ref_unc).mean()
    return absrel, inliers
