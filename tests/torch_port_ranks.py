"""One rank of ``tests/test_torch_port_parallel.py``'s data-parallel step (torch
and the port only; run by ``python -m robustmvd_tpu_torch.launch --local N``).

    python tests/torch_port_ranks.py PAYLOAD OUT_DIR

PAYLOAD (``torch.save``) maps a model name to its case: ``state`` (a port
state dict), ``kwargs`` of ``create_model``, ``loss``, ``iteration``, the
global batch's ``inputs`` and ``gt`` (numpy, batch-first; a tuple value is a
pair of batch-first arrays, as ``depth_range``). Each rank builds the
training engine with the mesh (``DistributedDataParallel`` over the gloo
group), takes its slice ``rank::world`` of the batch and calls the engine's
``train_step`` with an SGD of learning rate 0, so that the parameters stay
and their gradients are the step's. Rank 0 saves, per case, the loss
averaged over the ranks as the engine logs it, the gradients, the state
dict (BatchNorm running statistics) and each rank's loader indices, and, for
a case with ``single`` set, the same of one step of the model on the whole
batch in this process alone, to ``OUT_DIR/rank0.pt``.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

import robustmvd_tpu_torch as rmvd
from robustmvd_tpu_torch.parallel import MeshSpec, init_distributed_from_env, make_mesh


def rank_slice(value, rank, world):
    if isinstance(value, tuple):
        return tuple(rank_slice(v, rank, world) for v in value)
    return torch.from_numpy(np.ascontiguousarray(value[rank::world]))


def step_result(model):
    return {"grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def main(payload_path, out_dir):
    torch.set_num_threads(2)
    assert init_distributed_from_env()
    mesh = make_mesh(MeshSpec())
    rank, world = dist.get_rank(), dist.get_world_size()
    results = {}
    for name, case in torch.load(payload_path, weights_only=False).items():
        model = rmvd.create_model(name, device="cpu", train=True, **case["kwargs"])
        model.load_state_dict(case["state"], strict=True)
        optimizer = torch.optim.SGD(model.parameters(), lr=0.0)
        dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=6, num_views=2, height=64, width=64)
        training = rmvd.create_training(
            "mvd", out_dir=f"{out_dir}/{name}", model=model, dataset=dataset, optimizer=optimizer, scheduler=None,
            loss=rmvd.create_loss(case["loss"], model=model), batch_size=1, max_iterations=1, num_workers=0,
            mesh=mesh, verbose=False)
        training.finished_iterations = case["iteration"]
        inputs = {k: rank_slice(v, rank, world) for k, v in case["inputs"].items()}
        gt = {k: rank_slice(v, rank, world) for k, v in case["gt"].items()}
        loss, _ = training.train_step(inputs, gt)
        global_loss, _ = training._global_losses(loss, {})
        indices = [None] * world
        dist.all_gather_object(indices, list(training.dataloader.dataset.indices))
        results[name] = {"loss": float(global_loss), "local_loss": float(loss), "indices": indices,
                         "ddp": type(training.train_model).__name__, **step_result(model)}
        if rank == 0 and case.get("single"):  # the unsharded step of the port on the global batch
            single = rmvd.create_model(name, device="cpu", train=True, **case["kwargs"])
            single.load_state_dict(case["state"], strict=True)
            inputs = {k: rank_slice(v, 0, 1) for k, v in case["inputs"].items()}
            pred, aux = single(**inputs)
            total = rmvd.create_loss(case["loss"], model=single)(
                inputs, {k: rank_slice(v, 0, 1) for k, v in case["gt"].items()}, pred, aux,
                iteration=case["iteration"])[0]
            total.backward()
            results[name]["single"] = {"loss": float(total), **step_result(single)}
    if rank == 0:
        torch.save(results, f"{out_dir}/rank0.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
