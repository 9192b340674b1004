"""Stub external repositories for the wrapped models.

The wrapped models (``models/wrappers/``) import an external repository
(Vis-MVSNet, CVP-MVSNet, mvsnet_pl, PatchmatchNet, monodepth2, MiDaS) and
load its pretrained weights. Those repositories are fetched by
``scripts/setup_*.sh``, which needs the network, so the tests and
``chip_smoke.py`` write stubs instead: each has the real repository's import
layout, entry point and calling convention, a network of a few channels
that uses every input the wrapper hands it (images, cameras, depth range),
and its own seeded weights in the real checkpoint's file, container and key
naming. Everything the wrapper owns (resizes, normalisation, cam packing,
projection matrices, depth samples, the device plumbing, the output
conversion) then runs for real.

Imports numpy and torch only: ``chip_smoke.py`` uses it on the GPU machine,
which has no JAX.

    paths_file = write_stub_repos(root, seed=0)

writes the six repositories under ``root`` and a ``paths.toml`` naming them,
for a wrappers module's ``PATHS_FILE``. ``STUB_MODULES`` are the top-level
module names the stubs put in ``sys.modules``: mvsnet_pl, PatchmatchNet and
CVP-MVSNet each import a top-level ``models`` package, so a process that
builds more than one of them must remove these between builds
(:func:`isolated_imports`).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os
import sys

import torch

# the seven registry names and the repository each imports
WRAPPED = {
    "vis_mvsnet_wrapped": "vis_mvsnet",
    "cvp_mvsnet_wrapped": "cvp_mvsnet",
    "mvsnet_pl_wrapped": "mvsnet_pl",
    "patchmatchnet_wrapped": "patchmatchnet",
    "monodepth2_mono_stereo_1024x320_wrapped": "monodepth2",
    "monodepth2_mono_stereo_640x192_wrapped": "monodepth2",
    "midas_big_v2_1_wrapped": "midas",
}
STUB_MODULES = ("model", "models", "networks", "midas")
# the monodepth2 encoders' input sizes (height, width), their checkpoints' "height" / "width"
MONODEPTH2_SIZES = {"mono+stereo_1024x320": (48, 160), "mono+stereo_640x192": (64, 128)}

_VIS = '''
import torch
import torch.nn as nn


class Model(nn.Module):
    """Vis-MVSNet's entry point: forward(sample, depth_nums, interval_scales, mode)."""

    def __init__(self):
        super().__init__()
        self.feat = nn.Conv2d(3, 4, 3, padding=1)
        self.head = nn.Conv2d(8, 2, 3, padding=1)

    def forward(self, sample, depth_nums, interval_scales, mode="soft"):
        ref, ref_cam, srcs, srcs_cam = sample["ref"], sample["ref_cam"], sample["srcs"], sample["srcs_cam"]
        f_ref = self.feat(ref)
        f_src = torch.stack([self.feat(srcs[:, i]) for i in range(srcs.shape[1])], 1).mean(1)
        baseline = (srcs_cam[:, :, 0, :3, 3] - ref_cam[:, None, 0, :3, 3]).norm(dim=-1).mean(1)
        focal = ref_cam[:, 1, 0, 0] / ref.shape[-1]
        x = self.head(torch.cat([f_ref, f_src], 1)) + (baseline * focal)[:, None, None, None]
        start, interval, num = ref_cam[:, 1, 3, 0], ref_cam[:, 1, 3, 1], ref_cam[:, 1, 3, 2]
        span = (interval * num)[:, None, None, None] * interval_scales[-1] / interval_scales[0]
        depth = start[:, None, None, None] + torch.sigmoid(x[:, :1]) * span
        prob = torch.sigmoid(x[:, 1:2])
        return [], depth, [prob[:, :, ::4, ::4], prob[:, :, ::2, ::2], prob]
'''

_CVP = '''
import torch
import torch.nn as nn


class network(nn.Module):
    """CVP-MVSNet's entry point: network(args), args.nsrc source views."""

    def __init__(self, args):
        super().__init__()
        self.args = args
        self.feat = nn.Conv2d(3, 4, 3, padding=1)
        self.head = nn.Conv2d(4, 2, 3, padding=1)

    def forward(self, ref_img, src_imgs, ref_in, src_in, ref_ex, src_ex, depth_min, depth_max):
        assert src_imgs.shape[1] == self.args.nsrc
        cost = self.feat(ref_img)
        for i in range(self.args.nsrc):
            rel = torch.linalg.solve(ref_ex, src_ex[:, i])[:, :3, 3].norm(dim=-1)
            scale = (src_in[:, i, 0, 0] / ref_in[:, 0, 0] * rel)[:, None, None, None]
            cost = cost + self.feat(src_imgs[:, i]) * scale
        x = self.head(cost)
        lo, hi = depth_min[:, None, None], depth_max[:, None, None]
        depth = lo + torch.sigmoid(x[:, 0]) * (hi - lo)
        return {"depth_est_list": [depth], "prob_confidence": torch.sigmoid(x[:, 1])}
'''

_MVSNET_PL = '''
import torch
import torch.nn as nn


class MVSNet(nn.Module):
    """mvsnet_pl's MVSNet: forward(imgs, proj_mats, depth_values) -> depth, confidence."""

    def __init__(self):
        super().__init__()
        self.feat = nn.Conv2d(3, 4, 3, padding=1)
        self.head = nn.Conv2d(4, 1, 3, padding=1)

    def forward(self, imgs, proj_mats, depth_values):
        B, V, _, H, W = imgs.shape
        ref = self.feat(imgs[:, 0])
        var = sum((self.feat(imgs[:, v]) - ref) ** 2 for v in range(1, V)) / V
        geo = torch.stack([(proj_mats[:, 0] @ proj_mats[:, v])[:, :3, 3].norm(dim=-1) for v in range(1, V)], 1)
        score = self.head(var)[:, 0] * geo.mean(1)[:, None, None]
        D = depth_values.shape[1]
        logits = torch.stack([score * (d - D / 2) / D for d in range(D)], 1)
        prob = torch.softmax(logits, 1)
        depth = (prob * depth_values[:, :, None, None]).sum(1)
        return depth, prob.max(1).values
'''

_PATCHMATCHNET = '''
import torch
import torch.nn as nn


class PatchmatchNet(nn.Module):
    """PatchmatchNet: forward(imgs, proj intrinsics, extrinsics, depth_min, depth_max)."""

    def __init__(self, patchmatch_interval_scale, propagation_range, patchmatch_iteration,
                 patchmatch_num_sample, propagate_neighbors, evaluate_neighbors):
        super().__init__()
        self.num_sample = patchmatch_num_sample[-1]
        self.feat = nn.Conv2d(3, 4, 3, padding=1)
        self.head = nn.Conv2d(8, 2, 3, padding=1)

    def forward(self, imgs, intrinsics, extrinsics, depth_min, depth_max):
        ref = self.feat(imgs[0])
        src = sum(self.feat(img) for img in imgs[1:]) / (len(imgs) - 1)
        rel = torch.stack([torch.linalg.solve(extrinsics[:, 0], extrinsics[:, v])[:, :3, 3].norm(dim=-1)
                           for v in range(1, len(imgs))], 1).mean(1)
        x = self.head(torch.cat([ref, src], 1)) * (intrinsics[:, 0, 0, 0] / 100 * rel)[:, None, None, None]
        lo, hi = depth_min[:, None, None, None], depth_max[:, None, None, None]
        depth = lo + torch.sigmoid(x[:, :1]) * (hi - lo)
        return depth, torch.sigmoid(x[:, 1]), {"num_sample": self.num_sample}
'''

_MONODEPTH2 = '''
import numpy as np
import torch
import torch.nn as nn


class ResnetEncoder(nn.Module):
    """monodepth2's encoder: ResnetEncoder(num_layers, pretrained), num_ch_enc."""

    def __init__(self, num_layers, pretrained):
        super().__init__()
        self.num_ch_enc = np.array([4, 8])
        self.conv1 = nn.Conv2d(3, 4, 3, padding=1)
        self.conv2 = nn.Conv2d(4, 8, 3, stride=2, padding=1)

    def forward(self, input_image):
        x = torch.relu(self.conv1((input_image - 0.45) / 0.225))
        return [x, torch.relu(self.conv2(x))]


class DepthDecoder(nn.Module):
    """monodepth2's decoder: {("disp", scale): sigmoid disparity}."""

    def __init__(self, num_ch_enc, scales=range(4)):
        super().__init__()
        self.scales = list(scales)
        self.upconv = nn.Conv2d(int(num_ch_enc[1]), int(num_ch_enc[0]), 3, padding=1)
        self.dispconv = nn.Conv2d(int(num_ch_enc[0]), 1, 3, padding=1)

    def forward(self, input_features):
        x = nn.functional.interpolate(self.upconv(input_features[1]), scale_factor=2, mode="nearest")
        disp = torch.sigmoid(self.dispconv(torch.relu(x + input_features[0])))
        return {("disp", s): disp[:, :, :: 2 ** s, :: 2 ** s] for s in self.scales}
'''

_MIDAS_NET = '''
import torch
import torch.nn as nn


class MidasNet(nn.Module):
    """MiDaS v2.1's network: MidasNet(path, non_negative); loads its weights itself."""

    def __init__(self, path=None, features=256, non_negative=True):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.head = nn.Conv2d(4, 1, 3, padding=1)
        self.non_negative = non_negative
        if path:
            parameters = torch.load(path, map_location=torch.device("cpu"))
            if "optimizer" in parameters:
                parameters = parameters["model"]
            self.load_state_dict(parameters)

    def forward(self, x):
        out = self.head(torch.tanh(self.conv(x)))
        if self.non_negative:
            out = torch.relu(out) + 0.1
        return torch.squeeze(out, dim=1)
'''

_MIDAS_TRANSFORMS = '''
import math

import numpy as np


class Resize:
    """MiDaS's Resize (its sizing rules; nearest sampling instead of cv2's cubic)."""

    def __init__(self, width, height, resize_target=True, keep_aspect_ratio=False, ensure_multiple_of=1,
                 resize_method="lower_bound"):
        self.width, self.height = width, height
        self.keep_aspect_ratio = keep_aspect_ratio
        self.multiple_of = ensure_multiple_of
        self.resize_method = resize_method

    def constrain_to_multiple_of(self, x, min_val=0, max_val=None):
        y = (np.round(x / self.multiple_of) * self.multiple_of).astype(int)
        if max_val is not None and y > max_val:
            y = (np.floor(x / self.multiple_of) * self.multiple_of).astype(int)
        if y < min_val:
            y = (np.ceil(x / self.multiple_of) * self.multiple_of).astype(int)
        return y

    def get_size(self, width, height):
        scale_height, scale_width = self.height / height, self.width / width
        if self.keep_aspect_ratio and self.resize_method == "upper_bound":
            if scale_width < scale_height:
                scale_height = scale_width
            else:
                scale_width = scale_height
        new_height = self.constrain_to_multiple_of(scale_height * height, max_val=self.height)
        new_width = self.constrain_to_multiple_of(scale_width * width, max_val=self.width)
        return new_width, new_height

    def __call__(self, sample):
        height, width = sample["image"].shape[:2]
        new_width, new_height = self.get_size(width, height)
        ys = np.minimum((np.arange(new_height) + 0.5) * height / new_height, height - 1).astype(int)
        xs = np.minimum((np.arange(new_width) + 0.5) * width / new_width, width - 1).astype(int)
        sample["image"] = sample["image"][ys][:, xs]
        return sample


class NormalizeImage:
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def __call__(self, sample):
        sample["image"] = (sample["image"] - self.mean) / self.std
        return sample


class PrepareForNet:
    def __call__(self, sample):
        image = np.transpose(sample["image"], (2, 0, 1))
        sample["image"] = np.ascontiguousarray(image).astype(np.float32)
        return sample
'''


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _build(path, entry, *args, seed):
    """Import the stub module at ``path`` under a private name, build
    ``entry(*args)`` with weights from ``seed`` and return it."""
    spec = importlib.util.spec_from_file_location(f"_wrapper_stub_{seed}_{abs(hash(path))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    torch.manual_seed(seed)
    return getattr(module, entry)(*args)


def write_stub_repos(root, seed=0, lightning_hparams=False):
    """Write the six stub repositories under ``root`` and a paths.toml naming
    them; return the paths.toml's path. ``lightning_hparams``: mvsnet_pl's
    checkpoint also pickles an ``argparse.Namespace`` of hyper-parameters,
    as a Lightning ``.ckpt`` does (torch's weights-only loader refuses it)."""
    roots = {name: os.path.join(root, name) for name in ("vis_mvsnet", "cvp_mvsnet", "mvsnet_pl", "patchmatchnet",
                                                          "monodepth2", "midas")}

    _write(os.path.join(roots["vis_mvsnet"], "model", "__init__.py"), "")
    _write(os.path.join(roots["vis_mvsnet"], "model", "cas.py"), _VIS)
    net = _build(os.path.join(roots["vis_mvsnet"], "model", "cas.py"), "Model", seed=seed)
    path = os.path.join(roots["vis_mvsnet"], "pretrained_model", "vis", "20000.tar")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": net.state_dict(), "step": 20000}, path)

    inner = os.path.join(roots["cvp_mvsnet"], "CVP_MVSNet")
    _write(os.path.join(inner, "models", "__init__.py"), "")
    _write(os.path.join(inner, "models", "net.py"), _CVP)
    net = _build(os.path.join(inner, "models", "net.py"), "network", argparse.Namespace(nsrc=2), seed=seed + 1)
    path = os.path.join(inner, "checkpoints", "pretrained", "model_000027.ckpt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 27, "model": net.state_dict()}, path)

    _write(os.path.join(roots["mvsnet_pl"], "models", "__init__.py"), "")
    _write(os.path.join(roots["mvsnet_pl"], "models", "mvsnet.py"), _MVSNET_PL)
    net = _build(os.path.join(roots["mvsnet_pl"], "models", "mvsnet.py"), "MVSNet", seed=seed + 2)
    checkpoint = {"epoch": 14, "state_dict": {f"model.{k}": v for k, v in net.state_dict().items()}}
    if lightning_hparams:
        checkpoint["hparams"] = argparse.Namespace(n_depths=192, interval_ratio=1.06, lr=1e-3)
    torch.save(checkpoint, os.path.join(roots["mvsnet_pl"], "_ckpt_epoch_14.ckpt"))

    _write(os.path.join(roots["patchmatchnet"], "models", "__init__.py"), "")
    _write(os.path.join(roots["patchmatchnet"], "models", "net.py"), _PATCHMATCHNET)
    net = _build(os.path.join(roots["patchmatchnet"], "models", "net.py"), "PatchmatchNet",
                 [0.005, 0.0125, 0.025], [6, 4, 2], [1, 2, 2], [8, 8, 16], [0, 8, 16], [9, 9, 9], seed=seed + 3)
    path = os.path.join(roots["patchmatchnet"], "checkpoints", "params_000007.ckpt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 7, "model": {f"module.{k}": v for k, v in net.state_dict().items()}}, path)

    _write(os.path.join(roots["monodepth2"], "networks", "__init__.py"), _MONODEPTH2)
    for i, (name, (height, width)) in enumerate(sorted(MONODEPTH2_SIZES.items())):
        path = os.path.join(roots["monodepth2"], "networks", "__init__.py")
        encoder = _build(path, "ResnetEncoder", 18, False, seed=seed + 4 + i)
        decoder = _build(path, "DepthDecoder", encoder.num_ch_enc, range(4), seed=seed + 6 + i)
        model_dir = os.path.join(roots["monodepth2"], "models", name)
        os.makedirs(model_dir, exist_ok=True)
        torch.save({**encoder.state_dict(), "height": height, "width": width, "use_stereo": True},
                   os.path.join(model_dir, "encoder.pth"))
        torch.save(decoder.state_dict(), os.path.join(model_dir, "depth.pth"))

    _write(os.path.join(roots["midas"], "midas", "__init__.py"), "")
    _write(os.path.join(roots["midas"], "midas", "midas_net.py"), _MIDAS_NET)
    _write(os.path.join(roots["midas"], "midas", "transforms.py"), _MIDAS_TRANSFORMS)
    net = _build(os.path.join(roots["midas"], "midas", "midas_net.py"), "MidasNet", seed=seed + 8)
    os.makedirs(os.path.join(roots["midas"], "weights"), exist_ok=True)
    torch.save(net.state_dict(), os.path.join(roots["midas"], "weights", "midas_v21-f6b98070.pt"))

    paths_file = os.path.join(root, "paths.toml")
    _write(paths_file, "".join(f"[{name}]\nroot = '{path}'\n\n" for name, path in roots.items()))
    return paths_file


@contextlib.contextmanager
def isolated_imports():
    """Undo what building a wrapped model adds to ``sys.path`` and to
    ``sys.modules`` under the stubs' top-level names."""
    path = list(sys.path)
    try:
        yield
    finally:
        sys.path[:] = path
        for name in list(sys.modules):
            if name.split(".")[0] in STUB_MODULES:
                del sys.modules[name]


def stub_sample(seed, height=64, width=128, num_views=3, batched=False):
    """A 1+(num_views-1)-view sample in the run() contract: CHW images in
    0..255, poses moving sideways, intrinsics, the key view first, a depth
    range."""
    import numpy as np

    rng = np.random.RandomState(seed)
    images = [(rng.rand(3, height, width) * 255).astype(np.float32) for _ in range(num_views)]
    K = np.array([[0.9 * width, 0, width / 2], [0, 0.9 * width, height / 2], [0, 0, 1]], np.float32)
    poses = []
    for i in range(num_views):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1 * i, 0.02 * i, 0.05 * i]
        poses.append(T)
    sample = {"images": images, "poses": poses, "intrinsics": [K.copy() for _ in range(num_views)],
              "keyview_idx": 0, "depth_range": [np.float32(0.5), np.float32(20.0)]}
    if batched:
        sample = {"images": [x[None] for x in images], "poses": [x[None] for x in poses],
                  "intrinsics": [x[None] for x in sample["intrinsics"]], "keyview_idx": np.array([0]),
                  "depth_range": [np.array([0.5], np.float32), np.array([20.0], np.float32)]}
    return sample
