"""The port's bench (``robustmvd_tpu_torch/bench/``) against the JAX package's
``bench.py``, ``bench_scaling.py`` and ``tools/bench_eval_protocol.py``, on
the CPU at small sizes:

- the inputs are ``bench._mk_inputs``'s, in both intrinsics modes;
- the workload keys and metric names are ``bench.py``'s, read with ``ast``;
- the timed quantity (the depth's sum) of robust_mvd (S 32, 64x128) and
  mvsnet_train (D 16, 64x80) equals JAX's ``apply_fn`` on the same weights
  (rel 1e-4), and the recipe step's first loss JAX's ``loss_fn`` (rtol 1e-4),
  at fp32; JAX's robust_mvd takes its "matmul" correlation, the port's route
  (its default "pixelscan" departs by ~5e-3 near the epipole);
- the FLOP count does not move when each kernel's plain version is swapped
  for a stub that returns zeros: the kernels' work is their formulas, the
  same ones ``chip_smoke.py``'s bounds count;
- the eval protocol's table and rows, the scaling bench, the main's refusals,
  its error entries, exit code and summary line.
"""

import ast
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.loss import create_loss as jax_create_loss
from robustmvd_tpu.models.mvsnet import MVSNet as JaxMVSNet
from robustmvd_tpu.models.mvsnet import MVSNetModule
from robustmvd_tpu_torch import create_loss, create_model, create_optimizer, create_scheduler
from robustmvd_tpu_torch.bench import __main__ as bench_main
from robustmvd_tpu_torch.bench import eval_protocol, flops, inputs, scaling, timing, workloads
from robustmvd_tpu_torch.models.weights import variables_from_state_dict

# the wrappers' modules (the package's attributes of the same names are the wrapper functions)
conv3d, planesweep_sample, planesweep_sample_backward, soft_argmin, sweep_group_cost, sweep_warp, warp_volume = (
    importlib.import_module(f"robustmvd_tpu_torch.ops.kernels.{name}") for name in (
        "conv3d", "planesweep_sample", "planesweep_sample_backward", "soft_argmin", "sweep_group_cost",
        "sweep_warp", "warp_volume"))

from torch_port_helpers import run_jax_family, torch_threads

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402  (the JAX package's bench: its module level imports numpy only)
import chip_smoke  # noqa: E402

S = 32  # robust_mvd's hypotheses in the parity cases


def _jax_eval_protocol():
    spec = importlib.util.spec_from_file_location("jax_bench_eval_protocol", ROOT / "tools" / "bench_eval_protocol.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(2):
        yield


# --- inputs ---

@pytest.mark.parametrize("rel", [True, False], ids=["relative_K", "absolute_K"])
def test_inputs_are_the_jax_bench_inputs(rel):
    images, poses, intrinsics, keyview_idx = bench._mk_inputs(2, 3, 16, 24, np.random.RandomState(0),
                                                              rel_intrinsics=rel)
    ours = inputs.mk_inputs(2, 3, 16, 24, np.random.RandomState(0), rel_intrinsics=rel)
    np.testing.assert_array_equal(ours["images"].numpy(), np.asarray(images).transpose(0, 1, 4, 2, 3))
    np.testing.assert_array_equal(ours["poses"].numpy(), np.asarray(poses))
    np.testing.assert_array_equal(ours["intrinsics"].numpy(), np.asarray(intrinsics))
    np.testing.assert_array_equal(ours["keyview_idx"].numpy(), np.asarray(keyview_idx))


# --- keys and metric names, read from bench.py ---

def _jax_workloads():
    """[(key, metric regex)] of bench.py's main(): each lambda's call bound to
    its function's parameters, the function's own constants (``B, V, H, W =
    ...``, ``dtype = ...``) substituted into its metric f-string, every other
    field a wildcard."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    functions = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    listing = next(n.value for n in ast.walk(functions["main"])
                   if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "workloads")
    out = []
    for item in listing.elts:
        key, fn = item.elts[0].value, item.elts[1].body
        target = functions[fn.func.id]
        params = [a.arg for a in target.args.args]
        known = dict(zip(params[len(params) - len(target.args.defaults):],
                         (d.value for d in target.args.defaults)))
        known.update({p: a.value for p, a in zip(params, fn.args) if isinstance(a, ast.Constant)})
        known.update({k.arg: k.value.value for k in fn.keywords if isinstance(k.value, ast.Constant)})
        for node in ast.walk(target):
            if isinstance(node, ast.Assign) and isinstance(node.targets[0], (ast.Tuple, ast.Name)):
                names = node.targets[0].elts if isinstance(node.targets[0], ast.Tuple) else [node.targets[0]]
                values = node.value.elts if isinstance(node.value, ast.Tuple) else [node.value]
                known.update({n.id: v.value for n, v in zip(names, values) if isinstance(v, ast.Constant)})
        template = next(n for n in ast.walk(target) if isinstance(n, ast.JoinedStr)
                        and any(isinstance(v, ast.Constant) and "views" in v.value for v in n.values))
        pattern = "".join(re.escape(v.value) if isinstance(v, ast.Constant)
                          else re.escape(str(known[v.value.id])) if v.value.id in known and known[v.value.id]
                          is not None else "[a-z0-9_]*" for v in template.values)
        out.append((key, pattern))
    return out


def test_workload_keys_and_metrics_are_the_jax_bench():
    jax_workloads = _jax_workloads()
    assert [w.key for w in workloads.WORKLOADS] == [key for key, _ in jax_workloads]
    for w, (key, pattern) in zip(workloads.WORKLOADS, jax_workloads):
        assert re.fullmatch(pattern, w.metric), (key, w.metric, pattern)
    # the ones JAX writes out whole
    assert workloads.WORKLOADS[0].metric == "robust_mvd_forward_384x1280_3views_bfloat16"
    assert workloads.WORKLOADS[2].metric == "robust_mvd_train_step_b4_384x768_5views_bfloat16"
    assert workloads.WORKLOADS[3].metric == "mvsnet_train_forward_256x320_3views"
    assert workloads.WORKLOADS[9].metric == "vis_mvsnet_train_step_b2_256x320_3views_bfloat16"
    assert bench_main.HEADLINE in (ROOT / "bench.py").read_text()


# --- the timed quantities against JAX ---

@pytest.fixture(scope="module")
def robust_mvd_pair(tmp_path_factory):
    """The port's seeded robust_mvd (S 32, train mode, no remat) and the JAX
    model holding its weights (through a .pt, which JAX converts)."""
    with torch_threads(2):
        port = create_model("robust_mvd", device="cpu", train=True, remat=False, num_sampling_points=S)
    path = tmp_path_factory.mktemp("weights") / "robust_mvd.pt"
    torch.save(port.state_dict(), path)
    ref = jax_create_model("robust_mvd", pretrained=False, weights=str(path), train=True, remat=False,
                           num_sampling_points=S, corr_impl="matmul")
    return port, ref


def test_robust_mvd_forward_sum_matches_jax(robust_mvd_pair):
    port, ref = robust_mvd_pair
    images, poses, intrinsics, keyview_idx = bench._mk_inputs(1, 3, 64, 128, np.random.RandomState(0))
    fwd = jax.jit(lambda v, **s: jnp.sum(ref.apply_fn(v, **s)[0]["depth"].astype(jnp.float32)))
    expected = float(fwd(ref.variables, images=images, poses=poses, intrinsics=intrinsics, keyview_idx=keyview_idx))
    sample = inputs.mk_inputs(1, 3, 64, 128, np.random.RandomState(0))
    with torch.inference_mode():
        ours = float(workloads.forward_sum(port, sample, workloads.make_salts("cpu")[0]))
    assert ours == pytest.approx(expected, rel=1e-4)


def test_mvsnet_forward_sum_matches_jax():
    port = create_model("mvsnet_train", device="cpu", num_sampling_steps=16)
    variables = variables_from_state_dict(port.state_dict())
    views = inputs.family_views(1, 3, 64, 80, np.random.RandomState(0))
    pred, _ = run_jax_family(MVSNetModule(num_sampling_steps=16, warp_impl="xla"), variables,
                             JaxMVSNet.input_adapter, views)
    sample = inputs.family_sample(port, 1, 3, 64, 80, np.random.RandomState(0))
    with torch.inference_mode():
        ours = float(workloads.forward_sum(port, sample, workloads.make_salts("cpu")[0]))
    assert ours == pytest.approx(float(pred["depth"].sum()), rel=1e-4)


def test_recipe_step_first_loss_matches_jax(robust_mvd_pair):
    port, ref = robust_mvd_pair
    rng = np.random.RandomState(0)
    images, poses, intrinsics, keyview_idx = bench._mk_inputs(1, 3, 64, 128, rng)
    invdepth = (1.0 / (1.0 + 99.0 * rng.rand(1, 64, 128, 1))).astype(np.float32)
    loss_obj = jax_create_loss("robust_mvd_loss", model=ref)
    si = {"images": images, "poses": poses, "intrinsics": intrinsics, "keyview_idx": keyview_idx}

    @jax.jit
    def loss_fn(params):
        pred, aux = ref.apply_fn({**ref.variables, "params": params}, **si)
        return loss_obj(si, {"invdepth": jnp.asarray(invdepth)}, pred, aux, iteration=0, params=params)[0]

    expected = float(loss_fn(ref.variables["params"]))
    model = create_model("robust_mvd", device="cpu", train=True, remat=False, num_sampling_points=S)
    model.load_state_dict(port.state_dict())
    optimizer = create_optimizer("adam", model=model, lr=1e-4)
    run_iter = workloads.train_step_fn(
        model, create_loss("robust_mvd_loss", model=model), optimizer,
        create_scheduler("flownet_scheduler", optimizer=optimizer), 5.0,
        inputs.mk_inputs(1, 3, 64, 128, np.random.RandomState(0)), {"invdepth": inputs.gt_map(invdepth, "cpu")},
        workloads.make_salts("cpu"))
    first = float(run_iter(0))
    assert first == pytest.approx(expected, rel=1e-4)
    assert float(run_iter(1)) != first  # the step updated the weights


# --- the FLOP count ---

STUBS = {  # module, its plain version the wrapper runs on the CPU, a stub of the same result's shape and dtype
    planesweep_sample: ("planesweep_sample_reference",
                        lambda corr, y0, *_: torch.zeros(y0.shape, dtype=torch.float32)),
    planesweep_sample_backward: ("planesweep_sample_backward_reference",
                                 lambda grad, y0, wy, x0, wx, Hs, Ws, dtype=torch.float32:
                                 torch.zeros((grad.shape[0], Hs, Ws), dtype=dtype)),
    sweep_warp: ("sweep_variance_reference",
                 lambda ref, src, rot, trans, depth, valid, out_dtype=torch.float32:
                 torch.zeros((*ref.shape[:1], depth.shape[1], *ref.shape[1:]), dtype=out_dtype)),
    sweep_group_cost: ("homography_group_cost_reference",
                       lambda ref, src, A, Bm, w, groups=8, out_dtype=torch.float32:
                       torch.zeros((*w.shape, groups), dtype=out_dtype)),
    soft_argmin: ("fused_soft_argmin_reference",
                  lambda volume, window=2: (torch.zeros_like(volume),
                                            *(torch.zeros_like(volume[:, :1]) for _ in range(3)))),
    warp_volume: ("rt_planesweep_warp",
                  lambda src, rot, trans, depth: torch.zeros((src.shape[0], depth.shape[1], *src.shape[1:]))),
    conv3d: ("conv3d_banded_reference",
             lambda x, kernel, bias=None: torch.zeros((*x.shape[:4], kernel.shape[4]), dtype=x.dtype)),
}

# (model, kwargs, size): every kernel forward (K4 and K5 on mvsnet's banded + xla route)
COUNTED = [("robust_mvd", {"num_sampling_points": 8}, (64, 128), {"planesweep_sample"}),
           ("mvsnet_train", {"num_sampling_steps": 16, "conv3d_impl": "banded", "warp_impl": "xla"}, (64, 64),
            {"warp_volume", "conv3d_banded"}),
           ("cvp_mvsnet", {"nscale": 3}, (64, 64), {"sweep_warp"}),
           ("vis_mvsnet", {}, (64, 64), {"sweep_group_cost", "soft_argmin", "conv3d_banded"})]


def _forward_count(name, kwargs, size):
    model = create_model(name, device="cpu", **kwargs)
    H, W = size
    rng = np.random.RandomState(0)
    sample = (inputs.mk_inputs(1, 3, H, W, rng) if name == "robust_mvd"
              else inputs.family_sample(model, 1, 3, H, W, rng))
    with torch.inference_mode():
        return flops.count_flops(workloads.forward_sum, model, sample, workloads.make_salts("cpu")[0])


@pytest.mark.parametrize("name,kwargs,size,kernels", COUNTED, ids=[c[0] for c in COUNTED])
def test_flop_count_is_the_same_whichever_route_runs(monkeypatch, name, kwargs, size, kernels):
    total, by_kernel = _forward_count(name, kwargs, size)
    assert set(by_kernel) == kernels
    for module, (attr, stub) in STUBS.items():
        monkeypatch.setattr(module, attr, stub)
    stub_total, stub_by_kernel = _forward_count(name, kwargs, size)
    assert (stub_total, stub_by_kernel) == (total, by_kernel)
    assert total > sum(by_kernel.values()) > 0


def test_kernel_routes_hide_what_the_mode_counts():
    """K5's plain version is 27 matmuls the mode sees; the count holds its formula instead."""
    x, k = torch.randn(1, 4, 3, 5, 6), torch.randn(3, 3, 3, 6, 8)
    total, by_kernel = flops.count_flops(conv3d.conv3d_banded, x, k)
    assert total == by_kernel["conv3d_banded"] == 1 * 4 * 3 * 5 * 8 * 54 * 6
    assert flops.count_flops(conv3d.conv3d_banded_reference, x, k)[0] == 27 * 2 * (4 * 3 * 5) * 6 * 8


def test_kernel_formulas_are_the_hand_reckoning():
    assert planesweep_sample.planesweep_sample_flops(7680, 256) == 7680 * 256 * 12
    assert planesweep_sample_backward.planesweep_sample_backward_flops(18432, 256) == 18432 * 256 * 10
    assert sweep_warp.sweep_variance_flops(1, 2, 256, 96, 320, 32) == 256 * 96 * 320 * 2 * (15 + 11 * 32)
    assert sweep_group_cost.homography_group_cost_flops(1, 8, 96, 320, 32) == 8 * 96 * 320 * (45 + 9 * 32)
    assert soft_argmin.fused_soft_argmin_flops(2, 8, 96, 320) == 20 * 2 * 8 * 96 * 320
    assert warp_volume.homo_warp_volume_flops(1, 256, 96, 320, 32) == 256 * 96 * 320 * (15 + 7 * 32)
    assert conv3d.conv3d_banded_flops(1, 8, 96, 320, 32, 16) == 8 * 96 * 320 * 16 * 54 * 32
    assert conv3d.conv3d_banded_flops(1, 8, 96, 320, 8, 1, bias=True) == 8 * 96 * 320 * (54 * 8 + 1)


def test_chip_smoke_bounds_count_the_formulas():
    """The bounds chip_smoke.py prints take their flops from the formulas,
    with the values they had."""
    B, V, D, H, W, C = 1, 2, 16, 12, 20, 8
    ref, src = torch.zeros(B, H, W, C), torch.zeros(B, V, H, W, C)
    assert chip_smoke.k2_bound(ref, src, torch.float32, torch.ones(B, D))["flops"] == B * D * H * W * V * (15 + 11 * C)
    w = torch.zeros(B, D, H, W)
    assert chip_smoke.k2_group_bound(ref, src[:, 0], w, 4)["flops"] == B * D * H * W * (45 + 9 * C)
    assert chip_smoke.k3_bound(w)["flops"] == 20 * w.numel()
    assert chip_smoke.k4_bound(ref, torch.ones(B, D))["flops"] == B * D * H * W * (15 + 7 * C)
    assert chip_smoke.k5_bound_bf16(torch.zeros(B, C, D, H, W), 16)["flops"] == B * D * H * W * 16 * 54 * C
    y0 = torch.zeros(6, 5, dtype=torch.int32)
    k1 = chip_smoke.k1_bound(torch.zeros(6, 4, 4), y0, y0)
    assert k1["ops_ms"] == 6 * 5 * 12 / chip_smoke.F32_FLOPS_PER_S * 1e3
    assert chip_smoke.k1b_bound(torch.zeros(6, 5), 4, 4)["ops_ms"] == 6 * 5 * 10 / chip_smoke.F32_FLOPS_PER_S * 1e3


# --- the workloads' settings ---

def test_timer_salts_and_counts_calls_as_jax_does():
    seen = []
    seconds = timing.timeit(lambda i: seen.append(i), iters=4, burn_in=2, device="cpu")
    assert seen == [0, 1, 2, 100, 101, 102, 103] and seconds >= 0
    salts = workloads.make_salts("cpu")
    assert len(salts) == 200 and salts[7].dtype == torch.float32
    assert float(salts[7]) == float(np.float32(7) * np.float32(1e-6))


def test_fp32_runs_with_tf32_off_and_restores_it(monkeypatch):
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    monkeypatch.setattr(workloads, "_family_forward", lambda w, b: (None, 1))
    monkeypatch.setattr(workloads, "measure", lambda w, b, run_iter, batch: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)) or {"metric": w.metric})
    bench_ctx = workloads.Bench(device=torch.device("cpu"), peak=None, rng=np.random.RandomState(0))
    fp32, bf16 = workloads.WORKLOADS[3], workloads.WORKLOADS[4]
    assert fp32.run(bench_ctx)["note"] == workloads.FP32_NOTE
    assert "note" not in bf16.run(bench_ctx)
    assert seen == [(False, False), (True, True)]
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    monkeypatch.undo()
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


def test_a_workload_at_a_small_size_gives_jax_fields():
    w = dataclasses.replace(workloads.WORKLOADS[2], shape=workloads.Shape(1, 3, 64, 128))
    entry = w.run(workloads.Bench(device=torch.device("cpu"), peak=1e12, rng=np.random.RandomState(0), iters=1,
                                  burn_in=0))
    assert entry["metric"] == "robust_mvd_train_step_b1_64x128_3views_bfloat16"
    assert set(entry) == {"metric", "value", "unit", "msec_per_step", "mfu", "tflops_per_step"}
    assert entry["unit"] == "samples/s" and entry["value"] > 0 and 0 < entry["mfu"]


def test_peak_table():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.peak_flops("NVIDIA A100-SXM4-40GB") is None


# --- the evaluation protocol ---

def test_protocol_is_the_jax_protocol():
    assert eval_protocol.PROTOCOL == _jax_eval_protocol().PROTOCOL


def test_protocol_rows_have_the_jax_fields_but_xla_compiles():
    tree = ast.parse((ROOT / "tools" / "bench_eval_protocol.py").read_text())
    row = next(n for n in ast.walk(tree) if isinstance(n, ast.Dict)
               and any(isinstance(k, ast.Constant) and k.value == "xla_compiles" for k in n.keys))
    jax_fields = [k.value for k in row.keys]
    model = create_model("robust_mvd", device="cpu", num_sampling_points=8)
    rows = eval_protocol.run_protocol(model=model, samples=2, burn_in=1, verbose=False,
                                      protocol=[("scannet", (64, 128), 3, 1)])
    assert [list(r) for r in rows] == [[f for f in jax_fields if f != "xla_compiles"]]
    assert rows[0]["metric"] == "eval_protocol_scannet_64x128_3views" and rows[0]["view_sweep"] == "1..2"
    assert rows[0]["value"] > 0 and rows[0]["peak_hbm_gb"] is None and np.isfinite(rows[0]["ause"])


# --- the scaling bench and the suite's main ---

def test_scaling_on_the_cpu(capsys):
    args = scaling.parse_args(["--device", "cpu", "--height", "64", "--width", "128", "--iters", "1",
                               "--num_sampling_points", "8"])
    scaling.main(args)
    scaling.main(args, devices=[torch.device("cpu")] * 2)  # two replicas, each on its share of the batch
    entries = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [e["metric"] for e in entries] == ["robust_mvd_fwd_scaling_n1"] * 2 + ["robust_mvd_fwd_scaling_n2"]
    assert entries[0]["scaling_efficiency"] == 1.0 and entries[0]["devices"] == 1 and entries[0]["value"] > 0
    assert entries[2]["unit"] == "frames/s" and 0 < entries[2]["scaling_efficiency"]


def test_a_missing_card_is_refused_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_main.main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        scaling.main(scaling.parse_args([]))


class _Raises:
    key = "mvsnet_bf16"

    def run(self, bench_ctx):
        raise ValueError("planted")


def test_a_raising_workload_gives_an_error_entry_and_exit_1(monkeypatch, capsys):
    monkeypatch.setattr(workloads, "WORKLOADS", (_Raises(),))
    monkeypatch.setenv("RMVD_BENCH_EVAL_PROTOCOL", "0")
    monkeypatch.delenv("BENCH_ONLY", raising=False)
    assert bench_main.main(["--device", "cpu"]) == 1
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"metric": "mvsnet_bf16", "error": "ValueError: planted"}
    assert lines[-1]["all"] == {"mvsnet_bf16": "error"} and lines[-1]["value"] is None
    assert lines[-1]["device_kind"] == "cpu"


def test_bench_only_selects_by_key(monkeypatch, capsys):
    monkeypatch.setattr(workloads, "WORKLOADS", (_Raises(),))
    monkeypatch.setenv("RMVD_BENCH_EVAL_PROTOCOL", "0")
    monkeypatch.setenv("BENCH_ONLY", "robust_mvd,vis")
    assert bench_main.main(["--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["all"] == {}


def test_the_summary_line_of_the_whole_suite_is_short():
    entries = [{"metric": w.metric, "value": 12345.678, "unit": "frames/s", "msec_per_frame": 0.081,
                "mfu": 0.1234, "tflops_per_frame": 1.234} for w in workloads.WORKLOADS]
    entries += [{"metric": f"eval_protocol_{n}_{H}x{W}_{V}views", "value": 12345.678}
                for n, (H, W), V, _ in eval_protocol.PROTOCOL]
    line = json.dumps(bench_main.summary(entries, "NVIDIA H100 80GB HBM3"))
    assert len(line) < 2000
    out = json.loads(line)
    assert out["metric"] == "robust_mvd_forward_384x1280_3views" and len(out["all"]) == 15
    assert out["vs_baseline"] == round(12345.678 / (1.0 / 0.28), 3)
    assert bench_main.summary(entries[:2][::-1], "x", "float32")["value"] == 12345.678
