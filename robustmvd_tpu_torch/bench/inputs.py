"""The bench's inputs: the JAX bench's ``_mk_inputs`` (bench.py:86-100) and
its family samples (bench.py:370-387), the same arrays drawn from the same
``np.random.RandomState`` in the same order, in the port's layouts on the
device (views (B, V, 3, H, W), ground truth (B, 1, H, W)).
"""

from __future__ import annotations

import numpy as np
import torch


def mk_inputs(B, V, H, W, rng, rel_intrinsics=True, device="cpu"):
    """robust_mvd's forward inputs: images ``rng.rand - 0.4``, identity key
    pose and source views 0.1 i to the right, relative (or, with
    ``rel_intrinsics=False``, absolute) intrinsics, key view 0."""
    images = rng.rand(B, V, H, W, 3).astype(np.float32) - 0.4
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    for i in range(1, V):
        poses[:, i, 0, 3] = 0.1 * i
    if rel_intrinsics:
        K = np.array([[0.8, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], dtype=np.float32)
    else:
        K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], dtype=np.float32)
    intrinsics = np.tile(K, (B, V, 1, 1))
    return {"images": torch.from_numpy(np.ascontiguousarray(images.transpose(0, 1, 4, 2, 3))).to(device),
            "poses": torch.from_numpy(poses).to(device),
            "intrinsics": torch.from_numpy(intrinsics).to(device),
            "keyview_idx": torch.zeros((B,), dtype=torch.int64, device=device)}


def gt_map(a, device):
    """A (B, H, W, 1) numpy ground truth as a (B, 1, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(device)


def family_views(B, V, H, W, rng):
    """An MVSNet-family sample in the ``run()`` contract: images ``rng.rand
    * 255`` per view, absolute intrinsics, source views 0.1 i to the right,
    depth range 0.4..100."""
    images = [rng.rand(B, 3, H, W).astype(np.float32) * 255.0 for _ in range(V)]
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], dtype=np.float32)
    intrinsics = [np.tile(K, (B, 1, 1)) for _ in range(V)]
    poses = [np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))]
    for i in range(1, V):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * i
        poses.append(np.tile(T, (B, 1, 1)))
    depth_range = (np.full((B,), 0.4, np.float32), np.full((B,), 100.0, np.float32))
    return {"images": images, "keyview_idx": np.zeros((B,), np.int64), "poses": poses, "intrinsics": intrinsics,
            "depth_range": depth_range}


def family_sample(model, B, V, H, W, rng):
    """:func:`family_views` through the model's own ``input_adapter``: its
    forward inputs on its device."""
    return model.input_adapter(**family_views(B, V, H, W, rng))
