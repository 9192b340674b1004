"""Monodepth2 wrapped models (reference parity: rmvd/models/wrappers/monodepth2.py),
the JAX package's ``models/wrappers/monodepth2.py``; the original encoder
and decoder run on ``device``.

Single-view depth; fixed input size per checkpoint, read from the encoder
checkpoint's ``height`` / ``width``; evaluated with ``--max_source_views 0
--alignment median`` (eval_all.sh).
"""

from __future__ import annotations

import os.path as osp

import torch

from ...data.transforms import ResizeInputs
from ...utils import select_by_index
from ..helpers import to_device
from ..registry import register_model
from .wrappers import ModelWrappers, add_repo_to_path, check_pretrained, load_repo_checkpoint


class Monodepth2Wrapped(ModelWrappers):
    def __init__(self, device, model_name, trained_on_stereo):
        repo_path = add_repo_to_path("monodepth2")
        import networks  # from the monodepth2 repo

        self.device = device
        self.encoder = networks.ResnetEncoder(18, False)
        self.decoder = networks.DepthDecoder(num_ch_enc=self.encoder.num_ch_enc, scales=range(4))

        enc_path = osp.join(repo_path, "models", model_name, "encoder.pth")
        dec_path = osp.join(repo_path, "models", model_name, "depth.pth")
        if not (osp.isfile(enc_path) and osp.isfile(dec_path)):
            raise FileNotFoundError(
                f"Monodepth2 weights for {model_name} not found under {osp.join(repo_path, 'models')}."
            )
        enc_weights = load_repo_checkpoint(enc_path)
        self.encoder.load_state_dict({k: v for k, v in enc_weights.items() if k in self.encoder.state_dict()})
        self.decoder.load_state_dict(load_repo_checkpoint(dec_path))
        self.encoder.to(device).eval()
        self.decoder.to(device).eval()

        self.height = enc_weights["height"]
        self.width = enc_weights["width"]
        self.trained_on_stereo = trained_on_stereo

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        image = select_by_index(images, keyview_idx)
        orig_ht, orig_wd = images[0].shape[-2:]
        if (orig_ht, orig_wd) != (self.height, self.width):
            image = ResizeInputs(size=(self.height, self.width))({"images": [image]})["images"][0]
        image = image / 255.0
        return {"image": image}

    def __call__(self, image, **_):
        with torch.no_grad():
            features = self.encoder(to_device(image, self.device))
            outputs = self.decoder(features)
            disp = outputs[("disp", 0)]
            min_depth, max_depth = 0.1, 100
            min_disp, max_disp = 1 / max_depth, 1 / min_depth
            scaled_disp = min_disp + (max_disp - min_disp) * disp
            if self.trained_on_stereo:
                scaled_disp = scaled_disp / 5.4
            pred = {"depth": 1 / (scaled_disp + 1e-9)}
        return pred, {}


@register_model(trainable=False)
def monodepth2_mono_stereo_1024x320_wrapped(pretrained=True, weights=None, train=False, device="cuda", **kwargs):
    check_pretrained("monodepth2_mono_stereo_1024x320_wrapped", pretrained, weights)
    return Monodepth2Wrapped(device, model_name="mono+stereo_1024x320", trained_on_stereo=True)


@register_model(trainable=False)
def monodepth2_mono_stereo_640x192_wrapped(pretrained=True, weights=None, train=False, device="cuda", **kwargs):
    check_pretrained("monodepth2_mono_stereo_640x192_wrapped", pretrained, weights)
    return Monodepth2Wrapped(device, model_name="mono+stereo_640x192", trained_on_stereo=True)
