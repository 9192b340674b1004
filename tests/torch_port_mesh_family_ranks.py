"""One rank of ``tests/test_torch_port_mesh_family.py``: the MVSNet family
over the view and hyp mesh axes (torch and the port only; run by ``python
-m robustmvd_tpu_torch.launch --local 4``).

    python tests/torch_port_mesh_family_ranks.py PAYLOAD OUT_DIR

PAYLOAD (``torch.save``) holds:

- ``fetch``: window-fetch cases (``parallel/collectives.py::fetch_window``):
  a volume, the planes' total, every rank's window and a loss weight;
- ``layers``: D-sharded 3D layer cases (``ops/sharded3d.py``): the layer's
  kind and state, the whole input volume and a loss weight of the output's
  shape; ``bn``: BatchNorm cases in training, D-sharded (3D) and
  replicated (2D);
- ``models``: the forward cases, each a model name, its ``create_model``
  arguments, a port state dict, the inputs and the mesh;
- ``train``: vis_mvsnet's training step through the engine: state, the
  global batch, the mesh and the SGD learning rate.

Every rank writes ``OUT_DIR/rank<r>.pt``: for each fetch and layer case its
output share and the gradients of its share of the input and of the
parameters after a backward from its own loss, ``(weight[share] * y *
y).sum()`` (the sum over the ranks is the unsharded loss); for each model
case the depth and the calls of each kernel wrapper with the D extent of
the volume each call saw; for the train step the loss, the gradients after
``DistributedDataParallel``'s mean, the BatchNorm running statistics and a
float64 digest of the parameters after the step. The layer and fetch cases
run on mesh (1, 1, 4); ranks 1, 2 and 3 also compute the port's unsharded
forwards and step (``single``).
"""

import contextlib
import importlib
import sys

import numpy as np
import torch
import torch.distributed as dist

import robustmvd_tpu_torch as rmvd
from robustmvd_tpu_torch.ops import layers
from robustmvd_tpu_torch.parallel import (
    MeshSpec,
    fetch_window,
    hyp_group,
    init_distributed_from_env,
    make_mesh,
    shares,
    use_mesh,
)

# the modules (the package's names of the model modules are their registered functions)
cvp_blocks, vis_blocks, cvp_model, mvsnet_model, conv3d_module = (
    importlib.import_module(f"robustmvd_tpu_torch.{name}")
    for name in ("models.blocks.cvp_mvsnet", "models.blocks.vis_mvsnet", "models.cvp_mvsnet", "models.mvsnet",
                 "ops.conv3d"))

LAYER_KINDS = {
    "same_xla": lambda: conv3d_module.Conv3d(8, 8, impl="xla"),
    "same_banded": lambda: conv3d_module.Conv3d(8, 8, impl="banded"),
    "head_banded": lambda: conv3d_module.Conv3d(8, 1, bias=True, impl="banded"),
    "stride2": lambda: layers.Conv3d(8, 16, 3, stride=2, padding=1, bias=False),
    "down1x1": lambda: layers.Conv3d(8, 16, 1, stride=2, padding=0, bias=False),
    "deconv_s2": lambda: layers.ConvTranspose3d(16, 8, 3, stride=2, padding=1, output_padding=1, bias=False),
    "deconv_s1": lambda: layers.ConvTranspose3d(16, 8, 3, stride=1, padding=1, bias=False),
}

# the kernel wrappers as the models call them: (module, name, D extent of the call's volume)
WRAPPERS = {
    "sweep_warp": [(mvsnet_model, "warp_variance", lambda a, kw: a[4].shape[1]),
                   (cvp_model, "warp_variance_rt", lambda a, kw: a[4].shape[1]),
                   (cvp_blocks, "warp_variance_dense", lambda a, kw: a[4].shape[1])],
    "sweep_group_cost": [(vis_blocks, "homography_group_cost", lambda a, kw: a[4].shape[1])],
    "soft_argmin": [(vis_blocks, "fused_soft_argmin", lambda a, kw: a[0].shape[1])],
    "conv3d_banded": [(conv3d_module, "conv3d_banded", lambda a, kw: a[0].shape[2])],
}


@contextlib.contextmanager
def recorded_calls(model=None):
    """Each kernel wrapper's calls in the block, as the D extents they saw;
    ``warp_volume`` through the model's ``warp`` (K4, bound when built)."""
    calls = {name: [] for name in (*WRAPPERS, "warp_volume")}
    saved = []

    def recording(name, fn, extent):
        def call(*args, **kwargs):
            calls[name].append(int(extent(args, kwargs)))
            return fn(*args, **kwargs)
        return call

    for name, sites in WRAPPERS.items():
        for module, attr, extent in sites:
            saved.append((module, attr, getattr(module, attr)))
            setattr(module, attr, recording(name, getattr(module, attr), extent))
    if model is not None and hasattr(model, "warp"):
        model.warp = recording("warp_volume", model.warp, lambda a, kw: a[3].shape[1])
    try:
        yield calls
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def share_of(x, dim, total, axis):
    lo, hi = shares(total, axis.size)[axis.rank]
    return x.narrow(dim, lo, hi - lo)


def fetch_cases(cases):
    out = {}
    axis = hyp_group()
    for name, case in cases.items():
        x = share_of(case["x"], 2, case["total"], axis).clone().requires_grad_(True)
        y = fetch_window(x, 2, case["total"], case["windows"], axis)
        a, b = case["windows"][axis.rank]
        (case["weight"][:, :, a:b] * y * y).sum().backward()
        out[name] = {"y": y.detach(), "grad": x.grad}
    return out


def layer_cases(cases):
    out = {}
    axis = hyp_group()
    for name, case in cases.items():
        layer = LAYER_KINDS[case["kind"]]()
        layer.load_state_dict(case["state"])
        D = case["x"].shape[2]
        x = share_of(case["x"], 2, D, axis).clone().requires_grad_(True)
        y = layer(x, D)
        weight = share_of(case["weight"], 2, layer.d_out(D), axis)
        (weight * y * y).sum().backward()
        out[name] = {"y": y.detach(), "grad": x.grad,
                     "param_grads": {n: torch.zeros_like(p) if p.grad is None else p.grad
                                     for n, p in layer.named_parameters()}}
    return out


def bn_cases(cases):
    out = {}
    axis = hyp_group()
    for name, case in cases.items():
        bn = (layers.BatchNorm3d if case["x"].dim() == 5 else layers.BatchNorm2d)(case["x"].shape[1]).train()
        bn.load_state_dict(case["state"])
        if case["x"].dim() == 5:  # a D-sharded volume
            D = case["x"].shape[2]
            x, weight = (share_of(t, 2, D, axis) for t in (case["x"], case["weight"]))
        else:  # replicated over hyp
            x, weight = case["x"], case["weight"]
        x = x.clone().requires_grad_(True)
        y = bn(x)
        (weight * y * y).sum().backward()
        out[name] = {"y": y.detach(), "grad": x.grad, "param_grads": {n: p.grad for n, p in bn.named_parameters()},
                     "running": {k: v.clone() for k, v in bn.state_dict().items() if "running" in k}}
    return out


def build(case):
    model = rmvd.create_model(case["name"], device="cpu", **case["kwargs"])
    model.load_state_dict(case["state"], strict=True)
    return model


def model_forward(case, mesh=None):
    """depth, uncertainty and the kernel wrappers' calls of one forward."""
    model = build(case)
    with use_mesh(mesh), recorded_calls(model) as calls, torch.no_grad():
        pred, _ = model(**case["inputs"])
    return {"depth": pred["depth"], "depth_uncertainty": pred["depth_uncertainty"], "calls": calls}


def vis_loss(model):
    return rmvd.create_loss("vismvsnet_loss", model=model)


def train_step(case, mesh, out_dir, data_rank=None, data_size=1):
    """The engine's step on this data rank's part of the global batch, SGD
    at ``lr``: loss, gradients, running statistics and the parameters."""
    model = build(case)
    inputs, gt = case["inputs"], case["gt"]
    if data_rank is not None:
        B = gt["depth"].shape[0] // data_size
        pick = slice(data_rank * B, (data_rank + 1) * B)
        inputs = {k: (tuple(r[pick] for r in v) if isinstance(v, tuple) else v[pick]) for k, v in inputs.items()}
        gt = {k: v[pick] for k, v in gt.items()}
    optimizer = torch.optim.SGD(model.parameters(), lr=case["lr"])
    if mesh is None:
        pred, aux = model(**inputs)
        total = vis_loss(model)(inputs, gt, pred, aux, iteration=0)[0]
        total.backward()
        optimizer.step()
        loss = float(total.detach())
    else:
        dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=2, num_views=3, height=64, width=64)
        training = rmvd.create_training(
            "mvd", out_dir=out_dir, model=model, dataset=dataset, optimizer=optimizer, scheduler=None,
            loss=vis_loss(model), batch_size=1, max_iterations=1, num_workers=0, mesh=mesh, verbose=False)
        loss, _ = training.train_step(inputs, gt)
        loss = float(loss)
    return {"loss": loss,
            "grads": {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                      for n, p in model.named_parameters()},
            "running": {k: v.clone() for k, v in model.state_dict().items() if "running" in k},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def digest(tensors):
    """(sum, sum of squares) in float64 over every tensor: equal on ranks
    that hold the same values."""
    flat = torch.cat([t.reshape(-1).double() for _, t in sorted(tensors.items())])
    return float(flat.sum()), float(flat.square().sum())


def main(payload_path, out_dir):
    torch.set_num_threads(1)
    assert init_distributed_from_env()
    rank = dist.get_rank()
    payload = torch.load(payload_path, weights_only=False)
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(MeshSpec(*shape))
        return meshes[shape]

    result = {}
    with use_mesh(mesh_of((1, 1, 4))):
        result["fetch"] = fetch_cases(payload["fetch"])
        result["layers"] = layer_cases(payload["layers"])
        result["bn"] = bn_cases(payload["bn"])
    result["models"] = {name: model_forward(case, mesh_of(case["mesh"])) for name, case in payload["models"].items()}

    case = payload["train"]
    mesh = mesh_of(case["mesh"])
    step = train_step(case, mesh, f"{out_dir}/train{rank}", mesh.get_local_rank("data"), mesh.size(0))
    step["digest"] = digest(step["params"])
    if rank != 0:
        del step["grads"], step["params"]
    result["train"] = step
    result["train_mesh"] = case["mesh"]

    # the unsharded port, the references spread over ranks 1-3
    singles = {1: ("mvsnet_3", "mvsnet_4"), 2: ("vis_114", "cvp_114"), 3: ()}
    result["single"] = {name: model_forward(payload["models"][name]) for name in singles.get(rank, ())}
    if rank == 3:
        result["single"]["train"] = train_step(case, None, None)
        del result["single"]["train"]["params"]
    torch.save(result, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
