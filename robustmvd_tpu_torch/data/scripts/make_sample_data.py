#!/usr/bin/env python3
"""Generate the bundled ``sample_data/`` folder for the inference CLI demo.

The reference ships captured photos (reference: sample_data/); this build
generates an equivalent folder procedurally so no binary assets need to be
copied: a textured 3D plane observed from a key view and three source
views. Geometry is exact — source images are rendered through the
plane-induced homography — so a correct multi-view depth model recovers
the plane from the generated views.

Layout (consumed by robustmvd_tpu_torch/inference.py:load_data, reference inference.py:18-55):
    sample_data/key/{image.png,K.npy,to_ref_transform.npy}
    sample_data/source/<i>/{image.png,K.npy,to_ref_transform.npy}

Convention: ``to_ref_transform`` composes per load_data's
``pose = src_to_ref @ inv(key_to_ref)`` into the model's key->view pose
(X_view = R @ X_key + t). With the key at identity we therefore store the
key->view matrix for each source view.

Usage: python -m robustmvd_tpu_torch.data.scripts.make_sample_data [out_dir]

A copy of the JAX package's ``robustmvd_tpu/data/scripts/make_sample_data.py``
(the port imports nothing of that package); run it as
``python -m robustmvd_tpu_torch.data.scripts.make_sample_data``.
"""

import os
import os.path as osp
import sys

import numpy as np


def _texture(h, w, seed=7):
    """Smooth multi-octave random texture plus a grid overlay (gives the

    matcher unambiguous gradients in both directions)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.float32)
    for octave in (8, 16, 32, 64):
        low = rng.rand(octave, octave, 3).astype(np.float32)
        ys = np.linspace(0, octave - 1, h)
        xs = np.linspace(0, octave - 1, w)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, octave - 1)
        x1 = np.minimum(x0 + 1, octave - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        img += (
            low[y0][:, x0] * (1 - wy) * (1 - wx)
            + low[y0][:, x1] * (1 - wy) * wx
            + low[y1][:, x0] * wy * (1 - wx)
            + low[y1][:, x1] * wy * wx
        ) / 4.0
    yy, xx = np.mgrid[0:h, 0:w]
    grid = ((yy // 24 + xx // 24) % 2).astype(np.float32) * 0.15
    img = np.clip(img * 0.8 + grid[..., None] + 0.05, 0, 1)
    return (img * 255).astype(np.uint8)


def _rotation(rx, ry, rz):
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float64)


def _bilinear(img, xs, ys):
    """Sample HxWx3 uint8 at float pixel coords (border clamp)."""
    h, w = img.shape[:2]
    xs = np.clip(xs, 0, w - 1.0)
    ys = np.clip(ys, 0, h - 1.0)
    x0 = np.floor(xs).astype(int)
    y0 = np.floor(ys).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    f = img.astype(np.float32)
    out = (
        f[y0, x0] * (1 - wy) * (1 - wx)
        + f[y0, x1] * (1 - wy) * wx
        + f[y1, x0] * wy * (1 - wx)
        + f[y1, x1] * wy * wx
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def main(out_dir="sample_data", height=256, width=320):
    from PIL import Image

    K = np.array(
        [[0.9 * width, 0, width / 2.0], [0, 0.9 * width, height / 2.0], [0, 0, 1]],
        dtype=np.float64,
    )
    # slanted plane n^T X = c in key coords; depth at the principal axis = c/nz
    n = np.array([0.25, -0.15, 1.0])
    n /= np.linalg.norm(n)
    c = 5.0 * n[2]

    key_img = _texture(height, width)

    key_dir = osp.join(out_dir, "key")
    os.makedirs(key_dir, exist_ok=True)
    Image.fromarray(key_img).save(osp.join(key_dir, "image.png"))
    np.save(osp.join(key_dir, "K.npy"), K.astype(np.float32))
    np.save(osp.join(key_dir, "to_ref_transform.npy"), np.eye(4, dtype=np.float32))

    views = [
        (_rotation(0.00, -0.02, 0.00), np.array([0.35, 0.00, 0.00])),
        (_rotation(0.01, 0.02, 0.00), np.array([-0.30, 0.05, 0.05])),
        (_rotation(-0.01, 0.00, 0.01), np.array([0.10, -0.30, -0.05])),
    ]
    Kinv = np.linalg.inv(K)
    ys_pix, xs_pix = np.mgrid[0:height, 0:width].astype(np.float64)
    ones = np.ones_like(xs_pix)
    pix = np.stack([xs_pix, ys_pix, ones], axis=-1)  # (H, W, 3)

    for i, (R, t) in enumerate(views, start=1):
        # plane-induced homography key->view in pixels, then render the view
        # by pulling key texture through its inverse
        H = K @ (R + np.outer(t, n) / c) @ Kinv
        Hinv = np.linalg.inv(H)
        src = pix @ Hinv.T
        xs = src[..., 0] / src[..., 2]
        ys = src[..., 1] / src[..., 2]
        view_img = _bilinear(key_img, xs, ys)

        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = R
        T[:3, 3] = t
        src_dir = osp.join(out_dir, "source", str(i))
        os.makedirs(src_dir, exist_ok=True)
        Image.fromarray(view_img).save(osp.join(src_dir, "image.png"))
        np.save(osp.join(src_dir, "K.npy"), K.astype(np.float32))
        np.save(osp.join(src_dir, "to_ref_transform.npy"), T.astype(np.float32))

    # ground-truth key depth for checking predictions: z = c / (n^T K^-1 x)
    rays = pix @ Kinv.T
    depth = c / (rays @ n)
    np.save(osp.join(out_dir, "gt_depth_key.npy"), depth.astype(np.float32))
    print(f"Wrote {out_dir}: key + {len(views)} source views, "
          f"depth range [{depth.min():.2f}, {depth.max():.2f}]")


if __name__ == "__main__":
    main(*(sys.argv[1:2] or ["sample_data"]))
