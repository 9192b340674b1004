"""One rank of ``tests/test_torch_port_mesh_axes.py``: robust_mvd sharded over
the view and hyp mesh axes (torch and the port only; run by ``python -m
robustmvd_tpu_torch.launch --local 4``).

    python tests/torch_port_mesh_ranks.py PAYLOAD OUT_DIR

PAYLOAD (``torch.save``) holds ``state`` (a port state dict of robust_mvd),
the global batch's ``inputs`` and ``gt`` (numpy, batch-first), ``meshes``
(the (data, view, hyp) shapes of the sharded forward), ``collectives``
(seeded inputs of the collectives' check) and ``lr`` (the engine step's SGD
learning rate). Every rank writes ``OUT_DIR/rank<r>.pt``:

- ``collectives``: per case, this rank's output and its input's gradient
  after a backward from its own loss, ``(weight[r] * f(y)).sum()``;
- ``forward``: per mesh, this rank's invdepth under ``use_mesh`` and the
  calls of K1's wrapper (``ops/corr.py``) and the hypotheses each took;
- ``step``: the engine's ``train_step`` under mesh (1, 2, 2) with an SGD of
  learning rate 0, the loss and the gradients after
  ``DistributedDataParallel``'s mean over the mesh;
- ``step_remat``: the same under mesh (1, 4, 1) with ``remat=True`` (the
  encoder on the rank's source views, one rank's share empty, the
  cost-volume encoder and the decoder recomputed in the backward);
- ``engine``: a run of the engine (``create_training``, one iteration, batch
  1 per data rank, SGD at ``lr``) on ``synthetic`` under mesh (2, 2, 1): the
  batches every rank trained on, the parameters after the step and the
  files the rank wrote under its own output directory.

The gradients and parameters are the same on every rank (DDP's mean): rank
0 keeps them, every rank a float64 ``digest`` of them. Ranks 1, 2 and 3
also compute the port's unsharded forward, train step and engine step on
the global batch (``single``).
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import robustmvd_tpu_torch as rmvd
import robustmvd_tpu_torch.ops.corr as corr_module
from robustmvd_tpu_torch.parallel import (
    MeshSpec,
    all_gather,
    all_reduce_sum,
    init_distributed_from_env,
    make_mesh,
    use_mesh,
    view_group,
)


def as_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def model_from(state, remat=False):
    model = rmvd.create_model("robust_mvd", device="cpu", train=True, remat=remat)
    model.load_state_dict(state, strict=True)
    return model


def collectives(cases, rank):
    """Each case's forward and this rank's input gradient, on a view axis of
    every rank (mesh (1, world, 1))."""
    out = {}
    with use_mesh(make_mesh(MeshSpec(data=1, view=dist.get_world_size(), hyp=1))):
        axis = view_group()
        for name, case in cases.items():
            x = torch.from_numpy(case["x"][rank]).requires_grad_(True)
            if case["op"] == "all_reduce_sum":
                y = all_reduce_sum(x, axis)
            else:
                y = all_gather(x, case["dim"], case["total"], axis)
            (torch.from_numpy(case["weight"][rank]) * y * y).sum().backward()
            out[name] = {"y": y.detach(), "grad": x.grad}
    return out


def counted_forward(model, inputs):
    """invdepth, and the hypotheses of each call of K1's wrapper."""
    calls = []
    sample = corr_module.planesweep_sample_with_grad

    def counted(corr_img, y0, *args):
        calls.append(y0.shape[-1])
        return sample(corr_img, y0, *args)

    corr_module.planesweep_sample_with_grad = counted
    try:
        with torch.no_grad():
            _, aux = model(**inputs)
    finally:
        corr_module.planesweep_sample_with_grad = sample
    return {"invdepth": aux["invdepth"], "k1_calls": calls}


def train_step(model, inputs, gt, out_dir, mesh):
    """The engine's step (SGD at learning rate 0): loss and gradients."""
    dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=2, num_views=2, height=64, width=64)
    training = rmvd.create_training(
        "mvd", out_dir=out_dir, model=model, dataset=dataset,
        optimizer=torch.optim.SGD(model.parameters(), lr=0.0), scheduler=None,
        loss=rmvd.create_loss("robust_mvd_loss", model=model), batch_size=1, max_iterations=1, num_workers=0,
        mesh=mesh, verbose=False)
    loss, _ = training.train_step(inputs, gt)
    return {"loss": float(loss), "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}


def single_step(state, inputs, gt, lr=0.0):
    """The unsharded step in this process: loss, gradients and, after SGD at
    ``lr``, the parameters."""
    model = model_from(state)
    pred, aux = model(**inputs)
    total = rmvd.create_loss("robust_mvd_loss", model=model)(inputs, gt, pred, aux, iteration=0)[0]
    total.backward()
    result = {"loss": float(total.detach()), "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
    if lr:
        torch.optim.SGD(model.parameters(), lr=lr).step()
        result["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    return result


def engine_run(state, lr, out_dir, mesh):
    """One iteration of the engine on synthetic under ``mesh``: the batch it
    trained on, the parameters after it and the files under ``out_dir``."""
    model = model_from(state)
    dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=4, num_views=4, height=64, width=64)
    training = rmvd.create_training(
        "mvd", out_dir=out_dir, model=model, dataset=dataset, optimizer=torch.optim.SGD(model.parameters(), lr=lr),
        scheduler=None, loss=rmvd.create_loss("robust_mvd_loss", model=model), batch_size=1, max_iterations=1,
        num_workers=0, mesh=mesh, verbose=False)
    seen = []
    step = training.train_step

    def noted_step(inputs, gt):
        seen.append(({k: v.clone() for k, v in inputs.items()}, {k: v.clone() for k, v in gt.items()}))
        return step(inputs, gt)

    training.train_step = noted_step
    training()
    files = sorted(os.path.relpath(os.path.join(d, f), out_dir) for d, _, fs in os.walk(out_dir) for f in fs)
    for d, _, fs in os.walk(out_dir):  # ~340 MB of snapshots on rank 0, read by nobody
        for f in fs:
            if f.endswith(".pt"):
                os.remove(os.path.join(d, f))
    return {"batch": seen, "params": {n: p.detach().clone() for n, p in model.named_parameters()}, "files": files}


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
    inputs, gt = as_torch(payload["inputs"]), as_torch(payload["gt"])
    result = {"collectives": collectives(payload["collectives"], rank), "forward": {}}

    model = model_from(payload["state"])
    for shape in payload["meshes"]:
        with use_mesh(make_mesh(MeshSpec(*shape))):
            result["forward"][shape] = counted_forward(model, inputs)

    result["step"] = train_step(model, inputs, gt, f"{out_dir}/step{rank}", make_mesh(MeshSpec(1, 2, 2)))
    result["step_remat"] = train_step(model_from(payload["state"], remat=True), inputs, gt, f"{out_dir}/remat{rank}",
                                      make_mesh(MeshSpec(1, 4, 1)))
    engine = engine_run(payload["state"], payload["lr"], f"{out_dir}/engine{rank}", make_mesh(MeshSpec(2, 2, 1)))
    batches = [None] * dist.get_world_size()
    dist.all_gather_object(batches, engine.pop("batch"))
    result["engine"] = {**engine, "batches": [{k: v.numpy() for k, v in b[0][0].items()} for b in batches]}

    # the unsharded port on the global batch, one reference on each of ranks 1-3
    if rank == 1:
        result["single"] = counted_forward(model_from(payload["state"]), inputs)
    elif rank == 2:
        result["single"] = single_step(payload["state"], inputs, gt)
    elif rank == 3:
        # the engine's global batch: data rank 0's sample (global ranks 0, 1), then data rank 1's (2, 3)
        (in0, gt0), (in1, gt1) = batches[0][0], batches[2][0]
        result["single"] = single_step(payload["state"], {k: torch.cat([in0[k], in1[k]]) for k in in0},
                                       {k: torch.cat([gt0[k], gt1[k]]) for k in gt0}, payload["lr"])
        del result["single"]["grads"]
    # every rank holds the same gradients and parameters (DDP's mean): rank 0 keeps them, the others a digest
    for key in ("step", "step_remat"):
        result[key]["digest"] = digest(result[key]["grads"])
    result["engine"]["digest"] = digest(result["engine"]["params"])
    if rank != 0:
        del result["step"]["grads"], result["step_remat"]["grads"], result["engine"]["params"]
    torch.save(result, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
