"""Multi-view depth training engine (reference:
rmvd/train/multi_view_depth_training.py:23-487), the JAX package's
``train/multi_view_depth_training.py`` in torch.

An iteration loop over a shuffled loader that drops the last partial batch:
batch augmentations on the host, the inputs / ground truth split (images
stay (B, V, 3, H, W)), then forward, loss, backward, the optional global
norm clip, the optimizer step and the schedule step. The loss sees the
number of finished iterations, the step count before the update, as the
JAX step's ``state["step"]``. It logs every ``print_interval`` (loss, time
per iteration), ``log_loss_interval`` (sub-losses, learning rate) and
``log_interval`` (with parameter norms) iterations through ``utils.logging``;
the JAX package's event writer is not ported. It saves the train state every
``save_checkpoint_interval_min`` minutes as ``snapshot-iter-{:09d}.pt``
(the newest 3 kept), resumes from the newest snapshot when built, and ends
with a train state and a weights-only snapshot that
``create_model(..., weights=...)`` loads.
"""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from ..data import create_batch_augmentation
from ..models.helpers import to_device
from ..optim import clip_grad_global_norm
from ..utils import logging
from ..utils.checkpoint import TrainStateSaver, WeightsOnlySaver
from .training import Training


class MultiViewDepthTraining(Training):
    def __init__(self, out_dir, model, dataset, optimizer, scheduler, loss, batch_size, max_iterations, inputs=None,
                 batch_augmentations=None, alignment=None, grad_clip_max_norm=None, num_workers=8,
                 print_interval=100, log_loss_interval=100, log_interval=5000, save_checkpoint_interval_min=20,
                 verbose=True, **_):
        if alignment is not None:
            raise NotImplementedError("alignment is not implemented for training (as in the reference)")
        self.verbose = verbose
        self.out_dir = out_dir
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

        self.dataloader = self.dataset.get_loader(batch_size=batch_size, shuffle=True, num_workers=num_workers,
                                                  drop_last=True)

        self.finished_iterations = 0
        self.saver_all = TrainStateSaver(self.checkpoints_dir, max_to_keep=3)
        self.saver_weights_only = WeightsOnlySaver(self.weights_only_checkpoints_dir)
        self._restore_state()
        self._start_iteration = self.finished_iterations

        if self.verbose:
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
        ret += f"\n\tBatch size: {self.batch_size}"
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
        steps. Returns the loss and the sub-losses, detached, on the device."""
        pred, aux = self.model(**sample_inputs)
        total, sub_losses, _ = self.loss(sample_inputs, sample_gt, pred, aux, iteration=self.finished_iterations)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        if self.grad_clip_max_norm is not None:
            clip_grad_global_norm(self.model.parameters(), self.grad_clip_max_norm)
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
                    sample_inputs, sample_gt = self.prepare_batch(sample)
                    loss, sub_losses = self.train_step(sample_inputs, sample_gt)

                    steps_since_print += 1
                    if self.finished_iterations % self.print_interval == 0:
                        dt = (time.time() - start_print) / steps_since_print
                        logging.info(f"Iteration {self.finished_iterations}/{self.max_iterations} - "
                                     f"{dt:1.4f} sec per iteration - loss: {float(loss):1.5f}")
                        start_print = time.time()
                        steps_since_print = 0

                    if self.finished_iterations % self.log_interval == 0:
                        self._log_all(loss, sub_losses)
                    elif self.finished_iterations % self.log_loss_interval == 0:
                        self._log_loss(loss, sub_losses)

                    self.finished_iterations += 1

                    if (self._start_iteration < self.finished_iterations < self.max_iterations
                            and time.time() - last_checkpoint_time > 60 * self.save_checkpoint_interval_min):
                        self._save_all()
                        last_checkpoint_time = time.time()

                    if self.finished_iterations >= self.max_iterations:
                        break

            self._write_checkpoints()
            logging.info(f"Finished training {self.name}.")
            return self.state()
        finally:
            logging.remove_log_file(self.log_file_path)

    def _log_loss(self, loss, sub_losses):
        lr = self.optimizer.param_groups[0]["lr"]
        subs = " ".join(f"{name}: {float(val):1.5f}" for name, val in sub_losses.items())
        logging.info(f"Iteration {self.finished_iterations} - loss: {float(loss):1.5f} - {subs} - lr: {lr:.6g}")

    def _log_all(self, loss, sub_losses):
        """The losses and each top-level module's parameter norm (the JAX
        engine also writes images and histograms to its event writer)."""
        self._log_loss(loss, sub_losses)
        norms = {}
        for name, p in self.model.named_parameters():
            top = name.split(".", 1)[0]
            norms[top] = norms.get(top, 0.0) + float((p.detach().double() ** 2).sum())
        logging.info("Parameter norms: " + " ".join(f"{top}: {np.sqrt(n):.5g}" for top, n in norms.items()))

    # ------------------------------------------------------------------

    def state(self):
        """The train state that a snapshot holds."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict() if self.scheduler is not None else None,
                "iteration": self.finished_iterations}

    def _save_all(self):
        path = self.saver_all.save(self.state(), self.finished_iterations)
        logging.info(f"Saved checkpoint {path}.")

    def _write_checkpoints(self):
        self._save_all()
        self.saver_weights_only.save(self.model.state_dict(), self.finished_iterations)

    def _restore_state(self):
        state, iteration = self.saver_all.restore()
        if state is None:
            return
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None and state["scheduler"] is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.finished_iterations = iteration
        logging.info(f"Restored checkpoint at iteration {self.finished_iterations}.")
