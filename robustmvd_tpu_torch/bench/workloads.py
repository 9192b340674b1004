"""The bench's workloads: the JAX bench's ten (bench.py:408-419), under its
keys and metric names.

- the robust_mvd forward, 384x1280, 1+2 views, S 256, at bf16 (K1 v2) and
  fp32 (K1) (bench.py:138-157);
- the paper recipe's train step at bf16: batch 4, 1+4 views, 384x768,
  ``robust_mvd_loss``, adam at lr 1e-4, ``flownet_scheduler``, the global
  norm clip at 5, without remat (bench.py:160-253; K1 v2 and K1b's bf16
  form);
- the forwards of mvsnet_train, vis_mvsnet and cvp_mvsnet at 256x320, 1+2
  views, at fp32 and bf16, through each model's ``input_adapter``
  (bench.py:363-391; K2, K2 group, K3, K5);
- vis_mvsnet's train step at bf16: batch 2, 1+2 views, 256x320,
  ``vismvsnet_loss``, adam at lr 1e-3, ``mvsnet_scheduler``, no clip
  (bench.py:256-348; the "xla" warp route that ``train=True`` takes, K3, K5).

Each times the model alone on inputs already on the device, as JAX times
``apply_fn``: a forward under ``torch.inference_mode()`` whose timed quantity
is the depth's sum, or a train step with the engine's pieces
(``train/multi_view_depth_training.py::train_step``) on a fixed batch. Every
call salts the images by its index (``images + i * 1e-6``, bench.py:109-118).
float32 workloads run with TF32 off for matmuls and cuDNN (JAX's fp32
forward is its bit-parity configuration), and their entries carry JAX's
note: their MFU is against the bf16 peak too.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..loss import create_loss
from ..models import create_model
from ..optim import clip_grad_global_norm, create_optimizer, create_scheduler
from .flops import count_flops
from .inputs import family_sample, gt_map, mk_inputs
from .timing import timeit

FP32_NOTE = "bit-parity configuration; MFU vs bf16 peak"
SALTS = 200  # distinct salts, reused in turn (bench.py:116)


@dataclasses.dataclass(frozen=True)
class Shape:
    B: int
    V: int
    H: int
    W: int


ROBUST_MVD_FORWARD = Shape(1, 3, 384, 1280)
RECIPE_STEP = Shape(4, 5, 384, 768)
FAMILY_FORWARD = Shape(1, 3, 256, 320)
VIS_STEP = Shape(2, 3, 256, 320)


@dataclasses.dataclass
class Bench:
    """What the workloads share: the device, the card's peak FLOP/s (None:
    no MFU), the one random stream they draw their inputs from in turn, and
    the timer's counts (``iters`` None: each workload's own)."""

    device: torch.device
    peak: float | None
    rng: np.random.RandomState
    iters: int | None = None
    burn_in: int = 3


@dataclasses.dataclass(frozen=True)
class Workload:
    """One entry of the bench: a ``model`` at ``dtype`` (None: the family's
    float32, unnamed in the metric as in JAX), a ``"forward"`` or a
    ``"train_step"``, at ``shape``, timed over ``iters`` calls."""

    key: str
    model: str
    kind: str
    dtype: str | None
    shape: Shape
    iters: int

    @property
    def metric(self):
        s = self.shape
        if self.kind == "train_step":
            return f"{self.model}_train_step_b{s.B}_{s.H}x{s.W}_{s.V}views_{self.dtype}"
        return f"{self.model}_forward_{s.H}x{s.W}_{s.V}views" + (f"_{self.dtype}" if self.dtype else "")

    def prepare(self, bench):
        """The model on ``bench.device`` and its inputs, drawn from
        ``bench.rng``: (``run_iter(i)``, the batch size). ``run_iter`` runs
        a forward or a step on inputs salted by ``i``."""
        build = {("robust_mvd", "forward"): _robust_mvd_forward, ("robust_mvd", "train_step"): _recipe_step,
                 ("vis_mvsnet", "train_step"): _vis_step}.get((self.model, self.kind), _family_forward)
        return build(self, bench)

    def run(self, bench):
        """Prepare, time, count: the bench entry."""
        fp32 = (self.dtype or "float32") == "float32"
        with precision(fp32):
            entry = measure(self, bench, *self.prepare(bench))
        if fp32:
            entry["note"] = FP32_NOTE
        return entry


WORKLOADS = (
    Workload("robust_mvd_bf16", "robust_mvd", "forward", "bfloat16", ROBUST_MVD_FORWARD, 20),
    Workload("robust_mvd_fp32", "robust_mvd", "forward", "float32", ROBUST_MVD_FORWARD, 20),
    Workload("train_step", "robust_mvd", "train_step", "bfloat16", RECIPE_STEP, 12),
    Workload("mvsnet", "mvsnet_train", "forward", None, FAMILY_FORWARD, 15),
    Workload("mvsnet_bf16", "mvsnet_train", "forward", "bfloat16", FAMILY_FORWARD, 15),
    Workload("vis_mvsnet", "vis_mvsnet", "forward", None, FAMILY_FORWARD, 15),
    Workload("vis_mvsnet_bf16", "vis_mvsnet", "forward", "bfloat16", FAMILY_FORWARD, 15),
    Workload("cvp_mvsnet", "cvp_mvsnet", "forward", None, FAMILY_FORWARD, 15),
    Workload("cvp_mvsnet_bf16", "cvp_mvsnet", "forward", "bfloat16", FAMILY_FORWARD, 15),
    Workload("vis_train_step", "vis_mvsnet", "train_step", "bfloat16", VIS_STEP, 10),
)


@contextlib.contextmanager
def precision(fp32):
    """TF32 off for matmuls and cuDNN in the block where ``fp32``; the
    previous settings restored after it."""
    if not fp32:
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def flop_count(workload, device, shape=None):
    """The FLOP count of one call of ``workload`` (at ``shape``, else its
    own) on ``device``, seeded weights and inputs: (total, {kernel: flops})."""
    if shape is not None:
        workload = dataclasses.replace(workload, shape=shape)
    run_iter, _ = workload.prepare(Bench(device=torch.device(device), peak=None, rng=np.random.RandomState(0)))
    return count_flops(run_iter, 0)


def make_salts(device):
    """The per-call salts ``i * 1e-6`` (float32), made once on the device."""
    return (torch.arange(SALTS, dtype=torch.float32, device=device) * 1e-6).unbind()


def forward_sum(model, sample, salt):
    """The timed quantity of a forward: the depth's sum in float32, of the
    model on ``sample`` with its images salted."""
    pred, _ = model(**{**sample, "images": sample["images"] + salt})
    return pred["depth"].float().sum()


def train_step_fn(model, loss, optimizer, scheduler, clip, sample_inputs, sample_gt, salts):
    """``run_iter(i)``: one update on the fixed batch with salted images,
    as the engine's ``train_step`` makes it (forward, loss at the number of
    finished steps, backward, the clip where ``clip`` is a norm, optimizer
    and schedule steps); returns the loss, detached."""
    finished = [0]

    def run_iter(i):
        si = {**sample_inputs, "images": sample_inputs["images"] + salts[i % SALTS]}
        pred, aux = model(**si)
        total, _, _ = loss(si, sample_gt, pred, aux, iteration=finished[0])
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if clip is not None:
            clip_grad_global_norm(model.parameters(), clip)
        optimizer.step()
        scheduler.step()
        finished[0] += 1
        return total.detach()

    return run_iter


def measure(workload, bench, run_iter, batch):
    """Time ``run_iter`` (``timing.timeit``), then count one call's FLOPs;
    the entry with JAX's fields: per frame for a forward, per step for a
    train step, the MFU against ``bench.peak`` where it is known."""
    sec = timeit(run_iter, iters=bench.iters or workload.iters, burn_in=bench.burn_in, device=bench.device)
    flops, _ = count_flops(run_iter, 0)
    if workload.kind == "train_step":
        entry = {"metric": workload.metric, "value": round(batch / sec, 3), "unit": "samples/s",
                 "msec_per_step": round(1000 * sec, 3)}
        per_item = {"tflops_per_step": round(flops / 1e12, 3)}
    else:
        entry = {"metric": workload.metric, "value": round(batch / sec, 3), "unit": "frames/s",
                 "msec_per_frame": round(1000 * sec / batch, 3)}
        per_item = {"tflops_per_frame": round(flops / batch / 1e12, 3)}
    if flops and bench.peak:
        entry["mfu"] = round(flops / sec / bench.peak, 4)
        entry.update(per_item)
    return entry


def _forward(model, sample, device):
    salts = make_salts(device)

    def run_iter(i):
        with torch.inference_mode():
            return forward_sum(model, sample, salts[i % SALTS])

    return run_iter, sample["images"].shape[0]


def _robust_mvd_forward(workload, bench):
    s = workload.shape
    model = create_model("robust_mvd", pretrained=False, weights=None, remat=False, dtype=workload.dtype,
                         device=bench.device)
    return _forward(model, mk_inputs(s.B, s.V, s.H, s.W, bench.rng, device=bench.device), bench.device)


def _family_forward(workload, bench):
    s = workload.shape
    kwargs = {} if workload.dtype is None else {"dtype": workload.dtype}
    model = create_model(workload.model, pretrained=False, weights=None, device=bench.device, **kwargs)
    return _forward(model, family_sample(model, s.B, s.V, s.H, s.W, bench.rng), bench.device)


def _recipe_step(workload, bench):
    s, rng, device = workload.shape, bench.rng, bench.device
    model = create_model("robust_mvd", pretrained=False, weights=None, train=True, remat=False,
                         dtype=workload.dtype, device=device)
    loss = create_loss("robust_mvd_loss", model=model)
    optimizer = create_optimizer("adam", model=model, lr=1e-4)
    scheduler = create_scheduler("flownet_scheduler", optimizer=optimizer)
    sample_inputs = mk_inputs(s.B, s.V, s.H, s.W, rng, device=device)
    sample_gt = {"invdepth": gt_map((1.0 / (1.0 + 99.0 * rng.rand(s.B, s.H, s.W, 1))).astype(np.float32), device)}
    return train_step_fn(model, loss, optimizer, scheduler, 5.0, sample_inputs, sample_gt, make_salts(device)), s.B


def _vis_step(workload, bench):
    s, rng, device = workload.shape, bench.rng, bench.device
    model = create_model("vis_mvsnet", pretrained=False, weights=None, train=True, dtype=workload.dtype,
                         device=device)
    loss = create_loss("vismvsnet_loss")
    optimizer = create_optimizer("adam", model=model, lr=1e-3)
    scheduler = create_scheduler("mvsnet_scheduler", optimizer=optimizer)
    sample_inputs = mk_inputs(s.B, s.V, s.H, s.W, rng, rel_intrinsics=False, device=device)
    sample_inputs["depth_range"] = (torch.full((s.B,), 2.0, device=device), torch.full((s.B,), 10.0, device=device))
    sample_gt = {"depth": gt_map((2.0 + 7.0 * rng.rand(s.B, s.H, s.W, 1)).astype(np.float32), device)}
    return train_step_fn(model, loss, optimizer, scheduler, None, sample_inputs, sample_gt, make_salts(device)), s.B
