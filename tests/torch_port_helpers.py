"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py).

The same numpy inputs go through a function of the JAX package and its
counterpart in ``robustmvd_tpu_torch`` (on the CPU, where each kernel wrapper
runs its plain version); weights made by the JAX package's ``init`` are
carried into the port with ``state_dict_from_jax``.
"""

import numpy as np
import torch

from test_epipolar import random_pose  # noqa: F401  (re-exported for the port tests)

from robustmvd_tpu_torch.models.weights import state_dict_from_jax

K_REL = np.array([[1.1, 0, 0.5], [0, 1.4, 0.5], [0, 0, 1]], dtype=np.float32)


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

