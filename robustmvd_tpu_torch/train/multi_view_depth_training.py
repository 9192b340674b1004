"""Multi-view depth training engine (reference:
rmvd/train/multi_view_depth_training.py:23-487), the JAX package's
``train/multi_view_depth_training.py`` in torch.

An iteration loop over a shuffled loader that drops the last partial batch:
batch augmentations on the host, the inputs / ground truth split (images
stay (B, V, 3, H, W)), then forward, loss, backward, the optional global
norm clip, the optimizer step and the schedule step. The loss sees the
number of finished iterations, the step count before the update, as the
JAX step's ``state["step"]``. It prints every ``print_interval`` iterations
(loss, time per iteration) through ``utils.logging``, and writes to the event
writer (``utils/writer.py``) as the JAX engine does: the host time of each
``log_loss_interval``-th iteration's batch preparation and step
(``00_overview/train_sec_iter``, with its average and ETA), the losses and
the learning rate every ``log_loss_interval`` iterations (``01_loss/*``,
``00_overview/lr``), and every ``log_interval`` iterations (iteration 0
included) also the norm of each top-level parameter group
(``03_params/*_norm``) and, where TensorBoard is written, the key image, the
ground-truth and predicted depth (``colormap_2d``) and each group's
histogram; the events are flushed every iteration. The JAX engine computes
the images and histograms whatever the backends; the port skips their
forward and host copies where no backend would take them (the JSONL log
holds scalars only). The logging forward runs without gradients in the
model's modes (vis's trained BatchNorm on the batch statistics, as JAX's
``apply_fn``) and leaves the train state as it was: parameters, BatchNorm
running statistics, optimizer and random generators. It saves the train
state every ``save_checkpoint_interval_min`` minutes as
``snapshot-iter-{:09d}.pt`` (the newest 3 kept), resumes from the newest
snapshot when built, and ends with a train state and a weights-only snapshot
that ``create_model(..., weights=...)`` loads. A snapshot's model state is
the ``state_dict``, BatchNorm running statistics included (the MVSNet family
trains them in place, as JAX's mutable-BN step threads them). The engine
never switches the model's mode: a model built with ``train=True`` trains in
the modes it was built with, and frozen BatchNorms stay in eval.

With a ``mesh`` (``parallel.make_mesh``) the engine trains on it, one
process per device, as the JAX engine's sharded step
(``robustmvd_tpu/train/multi_view_depth_training.py:102-121, 230-262``):
each rank loads the strided share ``rank::world`` of the dataset by its rank
on the data axis, shuffled with the seed ``7919 * (rank + 1)``, so the
global batch is ``batch_size`` times the data axis' size and the ranks of one
view x hyp group load the same batch; the forward runs under
``parallel.use_mesh``, so that the losses' masked means and the family's
BatchNorm statistics are the global batch's (``loss/utils.py``,
``ops/layers.py``; a D-sharded ``BatchNorm3d``'s are summed over hyp too)
and ``robust_mvd`` shards its views and hypotheses over the view and hyp
axes, the MVSNet family its hypotheses over hyp; it runs through
``DistributedDataParallel`` over every rank of the mesh (with
``find_unused_parameters``), whose mean of the ranks' gradients is the
global loss's gradient (``parallel/collectives.py`` says why under view and
hyp, for the halo fetches too); the
logged losses are averaged over the data axis; the global rank 0 alone
writes the log, events and snapshots, and its restored snapshot is broadcast
to the others.
"""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data import create_batch_augmentation
from ..models.helpers import to_device
from ..optim import clip_grad_global_norm
from ..parallel.context import use_mesh
from ..parallel.mesh import AXIS_DATA
from ..utils import logging, writer
from ..utils.checkpoint import TrainStateSaver, WeightsOnlySaver
from ..utils.vis import colormap_2d
from .training import Training


class MultiViewDepthTraining(Training):
    def __init__(self, out_dir, model, dataset, optimizer, scheduler, loss, batch_size, max_iterations, inputs=None,
                 batch_augmentations=None, alignment=None, grad_clip_max_norm=None, num_workers=8,
                 print_interval=100, log_loss_interval=100, log_interval=5000, save_checkpoint_interval_min=20,
                 mesh=None, verbose=True, **_):
        if alignment is not None:
            raise NotImplementedError("alignment is not implemented for training (as in the reference)")
        self.verbose = verbose
        self.out_dir = out_dir
        self.mesh = mesh
        # the data axis: the loader's share and the logged losses' mean
        self.group = mesh.get_group(AXIS_DATA) if mesh is not None else None
        self.world = dist.get_world_size(self.group) if mesh is not None else 1
        self.rank = dist.get_rank(self.group) if mesh is not None else 0
        self.writes = mesh is None or dist.get_rank() == 0
        self._init_dirs()

        self.dataset = dataset
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.loss = loss
        self.batch_size = batch_size
        self.grad_clip_max_norm = grad_clip_max_norm
        self.max_iterations = max_iterations
        self.inputs = list(set(inputs + ["images"])) if inputs is not None else ["images", "intrinsics", "poses"]

        batch_augmentations = batch_augmentations or []
        if not isinstance(batch_augmentations, list):
            batch_augmentations = [batch_augmentations]
        self.batch_augmentations = [create_batch_augmentation(a) if isinstance(a, str) else a
                                    for a in batch_augmentations]

        self.print_interval = print_interval
        self.log_interval = log_interval
        self.log_loss_interval = log_loss_interval
        self.save_checkpoint_interval_min = save_checkpoint_interval_min

        # data parallel: a strided share of the dataset per rank, each shuffled with its own seed, so a global
        # batch never holds one sample twice (JAX: multi_view_depth_training.py:102-121)
        loader_seed = loader_indices = None
        if self.world > 1:
            loader_seed = 7919 * (self.rank + 1)
            loader_indices = range(self.rank, len(self.dataset), self.world)
        self.dataloader = self.dataset.get_loader(batch_size=batch_size, shuffle=True, num_workers=num_workers,
                                                  drop_last=True, seed=loader_seed, indices=loader_indices)

        self.finished_iterations = 0
        self.saver_all = TrainStateSaver(self.checkpoints_dir, max_to_keep=3)
        self.saver_weights_only = WeightsOnlySaver(self.weights_only_checkpoints_dir)
        self._restore_state()
        self._start_iteration = self.finished_iterations
        self._step_lr = self.optimizer.param_groups[0]["lr"]

        self.train_model = self.model
        if mesh is not None:
            device = self.device
            # over every rank of the mesh; vis's occlusion heads get no gradient (its loss reads the first
            # uncertainty head only), nor does robust_mvd's fusion weight net with one source view
            self.train_model = torch.nn.parallel.DistributedDataParallel(
                self.model, device_ids=[device.index] if device.type == "cuda" else None,
                find_unused_parameters=True)

        if self.verbose and self.writes:
            logging.info(str(self))

    @property
    def name(self):
        return type(self).__name__

    @property
    def device(self):
        return next(self.model.parameters()).device

    def __str__(self):
        ret = f"{self.name} with settings:"
        ret += f"\n\tOutput directory: {self.out_dir}"
        ret += f"\n\tModel: {getattr(self.model, 'name', type(self.model).__name__)}"
        ret += f"\n\tModel parameter count: {sum(p.numel() for p in self.model.parameters())}"
        ret += f"\n\tDevice: {self.device}"
        ret += f"\n\tDataset: {self.dataset.name} ({len(self.dataset)} samples)"
        ret += f"\n\tOptimizer: {type(self.optimizer).__name__} (lr {self.optimizer.defaults['lr']})"
        ret += f"\n\tScheduler: {type(self.scheduler).__name__ if self.scheduler is not None else None}"
        ret += f"\n\tGrad clip max norm: {self.grad_clip_max_norm}"
        ret += f"\n\tLoss: {self.loss.name}"
        ret += f"\n\tBatch size: {self.batch_size}" + (
            f" per rank, {self.batch_size * self.world} over {self.world} ranks" if self.mesh is not None else "")
        ret += f"\n\tInputs: {self.inputs}"
        ret += f"\n\tFinished iterations: {self.finished_iterations}"
        ret += f"\n\tMax iterations: {self.max_iterations}"
        return ret

    def _init_dirs(self):
        self.log_file_path = osp.join(self.out_dir, "log.txt")
        self.artifacts_dir = osp.join(self.out_dir, "artifacts")
        self.checkpoints_dir = osp.join(self.out_dir, "checkpoints")
        self.weights_only_checkpoints_dir = osp.join(self.out_dir, "weights_only_checkpoints_dir")
        for d in (self.out_dir, self.artifacts_dir, self.checkpoints_dir, self.weights_only_checkpoints_dir):
            os.makedirs(d, exist_ok=True)
        if self.writes:
            logging.add_log_file(self.log_file_path, flush_line=True)

    # ------------------------------------------------------------------

    def prepare_batch(self, sample):
        """A collated numpy batch -> (inputs, ground truth), tensors on the
        model's device, after the batch augmentations."""
        for aug in self.batch_augmentations:
            aug(sample)

        device = self.device
        inputs = {"images": to_device(np.stack(sample["images"], axis=1), device)}  # (B, V, 3, H, W)
        if "poses" in self.inputs and "poses" in sample:
            inputs["poses"] = to_device(np.stack(sample["poses"], axis=1), device)
        if "intrinsics" in self.inputs and "intrinsics" in sample:
            inputs["intrinsics"] = to_device(np.stack(sample["intrinsics"], axis=1), device)
        if "depth_range" in self.inputs and "depth_range" in sample:
            inputs["depth_range"] = tuple(to_device(d, device) for d in sample["depth_range"])
        inputs["keyview_idx"] = to_device(np.asarray(sample["keyview_idx"]).reshape(-1), device, np.int64)

        gt = {key: to_device(sample[key], device) for key in ("depth", "invdepth") if key in sample}  # (B, 1, H, W)
        return inputs, gt

    def train_step(self, sample_inputs, sample_gt):
        """One update: forward, loss, backward, clip, optimizer and schedule
        steps. Returns the loss and the sub-losses, detached, on the device
        (under data parallelism the rank's share: the ranks' values average
        to the global batch's)."""
        with use_mesh(self.mesh):
            pred, aux = self.train_model(**sample_inputs)
            total, sub_losses, _ = self.loss(sample_inputs, sample_gt, pred, aux,
                                             iteration=self.finished_iterations)
            self.optimizer.zero_grad(set_to_none=True)
            total.backward()
        if self.grad_clip_max_norm is not None:
            clip_grad_global_norm(self.model.parameters(), self.grad_clip_max_norm)
        self._step_lr = self.optimizer.param_groups[0]["lr"]
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        return total.detach(), {k: v.detach() if torch.is_tensor(v) else v for k, v in sub_losses.items()}

    # ------------------------------------------------------------------

    def __call__(self):
        try:
            if self.finished_iterations >= self.max_iterations:
                logging.info("Training already finished.")
                return self.state()

            logging.info(f"Starting training {self.name}.")
            steps_since_print = 0
            start_print = time.time()
            last_checkpoint_time = time.time()

            while self.finished_iterations < self.max_iterations:
                for sample in self.dataloader:
                    it = self.finished_iterations
                    # the host's time: launches return before the card has run them (PERF.md)
                    with writer.TimeWriter(name="00_overview/train_sec_iter", step=it,
                                           write=self.writes and it % self.log_loss_interval == 0,
                                           avg_over_steps=True, update_eta=True, max_iterations=self.max_iterations):
                        sample_inputs, sample_gt = self.prepare_batch(sample)
                        loss, sub_losses = self.train_step(sample_inputs, sample_gt)

                    steps_since_print += 1
                    log_all, log_loss = it % self.log_interval == 0, it % self.log_loss_interval == 0
                    if it % self.print_interval == 0 or log_all or log_loss:
                        loss, sub_losses = self._global_losses(loss, sub_losses)
                    if it % self.print_interval == 0:
                        dt = (time.time() - start_print) / steps_since_print
                        if self.writes:
                            logging.info(f"Iteration {it}/{self.max_iterations} - "
                                         f"{dt:1.4f} sec per iteration - loss: {float(loss):1.5f}")
                        start_print = time.time()
                        steps_since_print = 0

                    if self.writes:
                        if log_all:
                            self._log_all(sample_inputs, sample_gt, loss, sub_losses)
                        elif log_loss:
                            self._log_loss(loss, sub_losses)

                    self.finished_iterations += 1

                    if (self._start_iteration < self.finished_iterations < self.max_iterations
                            and time.time() - last_checkpoint_time > 60 * self.save_checkpoint_interval_min):
                        self._save_all()
                        last_checkpoint_time = time.time()

                    writer.write_out_storage()

                    if self.finished_iterations >= self.max_iterations:
                        break

            self._write_checkpoints()
            logging.info(f"Finished training {self.name}.")
            return self.state()
        finally:
            logging.remove_log_file(self.log_file_path)

    def _global_losses(self, loss, sub_losses):
        """The loss and the sub-losses averaged over the data group (every rank
        calls it at the same iterations): the global batch's values."""
        if self.world == 1:
            return loss, sub_losses
        names = list(sub_losses)
        values = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=self.device).reshape(())
                              for v in [loss, *sub_losses.values()]])
        dist.all_reduce(values, group=self.group)
        values = values / self.world
        return values[0], dict(zip(names, values[1:]))

    def _log_loss(self, loss, sub_losses):
        """The losses and the step's learning rate, to the event writer and the
        log (reference: multi_view_depth_training.py:404-411)."""
        step = self.finished_iterations
        writer.put_scalar("01_loss/total", loss, step=step)
        for name, val in sub_losses.items():
            writer.put_scalar(f"01_loss/{name}", val, step=step)
        writer.put_scalar("00_overview/lr", self._step_lr, step=step)
        subs = " ".join(f"{name}: {float(val):1.5f}" for name, val in sub_losses.items())
        logging.info(f"Iteration {step} - loss: {float(loss):1.5f} - {subs} - lr: {self._step_lr:.6g}")

    def _log_all(self, sample_inputs, sample_gt, loss, sub_losses):
        """The losses, each top-level parameter group's norm and, where
        TensorBoard is written, the key image, the ground-truth and predicted
        depth and each group's histogram (reference:
        multi_view_depth_training.py:366-487). The forward runs on this
        rank's batch without gradients and leaves the train state as it was."""
        self._log_loss(loss, sub_losses)
        step = self.finished_iterations
        images = writer.writes_images()

        if images:
            pred = self._logging_forward(sample_inputs)
            img0 = sample_inputs["images"][0, 0].permute(1, 2, 0).float()  # (H, W, 3)
            key_image = torch.clamp((img0 - img0.min()) / (img0.max() - img0.min() + 1e-9) * 255, 0, 255)
            writer.put_tensor("00_inputs/key_image", key_image.to(torch.uint8), step=step)
            if "depth" in sample_gt:
                writer.put_tensor("01_gt/depth", colormap_2d(sample_gt["depth"][0, 0]), step=step)
            if "depth" in pred:
                writer.put_tensor("02_pred/depth", colormap_2d(pred["depth"][0, 0]), step=step)

        groups = {}
        for name, p in self.model.named_parameters():
            groups.setdefault(name.split(".", 1)[0], []).append(p.detach().reshape(-1))
        for top, leaves in groups.items():
            flat = torch.cat(leaves)
            if images:
                writer.put_histogram(f"03_params/{top}", flat, step=step)
            writer.put_scalar(f"03_params/{top}_norm", torch.linalg.vector_norm(flat), step=step)

    def _logging_forward(self, sample_inputs):
        """The model's prediction on ``sample_inputs`` in its current modes,
        without gradients, on this rank alone; the BatchNorm running
        statistics and the random generators are put back afterwards."""
        buffers = [(b, b.clone()) for b in self.model.buffers()]
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.no_grad(), torch.random.fork_rng(devices=devices):
            pred, _ = self.model(**sample_inputs)
            for b, kept in buffers:
                b.copy_(kept)
        return pred

    # ------------------------------------------------------------------

    def state(self):
        """The train state that a snapshot holds."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict() if self.scheduler is not None else None,
                "iteration": self.finished_iterations}

    def _save_all(self):
        if not self.writes:  # the state is replicated: one writer per snapshot path
            return
        path = self.saver_all.save(self.state(), self.finished_iterations)
        logging.info(f"Saved checkpoint {path}.")

    def _write_checkpoints(self):
        self._save_all()
        if self.writes:
            self.saver_weights_only.save(self.model.state_dict(), self.finished_iterations)

    def _restore_state(self):
        state, iteration = self.saver_all.restore() if self.writes else (None, None)
        if self.mesh is not None and dist.get_world_size() > 1:
            # rank 0's snapshot for every rank: a rank-local checkpoints directory holds none on the others
            box = [(state, iteration)]
            dist.broadcast_object_list(box, src=0)
            state, iteration = box[0]
        if state is None:
            return
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None and state["scheduler"] is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.finished_iterations = iteration
        logging.info(f"Restored checkpoint at iteration {self.finished_iterations}.")
