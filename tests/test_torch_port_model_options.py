"""robust_mvd's own options in the port, against the JAX package's.

- ``num_sampling_points`` / ``min_depth`` / ``max_depth``: the forward at
  S = 32 over 0.5..50 (``tests/test_corr.py:112-114``'s hypotheses), 64x128,
  key + 3 source views, weights from the JAX ``init`` at S = 32 bridged into
  the port, both through ``model.run``, within
  ``tests/test_torch_port_model.py``'s ``BOUNDS["matmul"]`` (mean 1e-4, max
  1e-3 of the mean); weights made for another S are refused with a message
  that names S.
- ``corr_impl``: every JAX name, at each compute dtype, is taken where its
  JAX route computes the port's function and refused with what the port
  computes otherwise (``ops/corr.py::corr_impl_of``); each taken name is held
  to its JAX route on the same features, at ``tests/test_torch_port_corr.py``'s
  and ``tests/test_torch_port_bf16.py``'s bounds.
- JAX's TPU tiling options ``slab_size`` and ``s2d`` are refused by name.
- The CLIs: ``--no_remat`` (train) and ``--num_gpus`` (train, eval,
  inference) parse; ``cli_model_kwargs`` gives JAX's result or JAX's exit.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustmvd_tpu.ops.corr as jax_corr_module
from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.models.factory import cli_model_kwargs as jax_cli_model_kwargs
from robustmvd_tpu.ops.corr import planesweep_correlation as jax_corr
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.eval.cli import parse_args as eval_parse_args
from robustmvd_tpu_torch.inference import parse_args as inference_parse_args
from robustmvd_tpu_torch.models import cli_model_kwargs
from robustmvd_tpu_torch.models.robust_mvd import RobustMVD
from robustmvd_tpu_torch.ops.corr import CORR_IMPL, CORR_REFUSED, CORR_TAKEN, corr_impl_of, planesweep_correlation
from robustmvd_tpu_torch.train.cli import parse_args as train_parse_args
from test_torch_port_model import BOUNDS, _check

from torch_port_helpers import K_REL, load_bridged, mvd_sample, random_pose, t, torch_threads

S_OPTIONS = {"num_sampling_points": 32, "min_depth": 0.5, "max_depth": 50.0}


@pytest.fixture(scope="module")
def sample():
    return mvd_sample(np.random.RandomState(7), 64, 128, num_views=4)


@pytest.fixture(scope="module")
def jax_model():
    return jax_create_model("robust_mvd", pretrained=False, corr_impl="matmul", **S_OPTIONS)


def test_s_option_forward_matches_jax(sample, jax_model):
    ref_pred, ref_aux = jax_model.run(**sample)
    with torch_threads(2):
        port = load_bridged(create_model("robust_mvd", device="cpu", **S_OPTIONS), jax_model.variables)
        pred, aux = port.run(**sample)
    assert port.fusion_block.corr_to_view_weight[0].in_channels == 32
    assert port.fusion_enc_block.conv3_1[0].in_channels == 32 + 32
    for key in ("invdepths_all", "invdepth_log_bs_all"):
        for scale, (o, r) in enumerate(zip(aux[key], ref_aux[key])):
            _check(o, np.asarray(r), BOUNDS["matmul"], f"{key}[{scale}]")
    invdepth = np.asarray(ref_aux["invdepth"])
    assert (invdepth > 0).mean() > 0.2  # the comparison is not vacuous
    rel = np.abs(pred["depth"] - ref_pred["depth"]) / ref_pred["depth"]
    assert rel[invdepth > 0].mean() <= BOUNDS["matmul"][0]


def test_weights_made_for_another_s_are_refused(jax_model, tmp_path):
    port = create_model("robust_mvd", device="cpu", num_sampling_points=64)
    with pytest.raises(ValueError, match="made for num_sampling_points=32.*this model has num_sampling_points=64"):
        load_bridged(port, jax_model.variables)
    path = tmp_path / "s32.pt"
    torch.save({"model_state_dict": create_model("robust_mvd", device="cpu", **S_OPTIONS).state_dict()}, path)
    with pytest.raises(ValueError, match="num_sampling_points=32"):
        create_model("robust_mvd", device="cpu", weights=str(path), num_sampling_points=16)
    assert create_model("robust_mvd", device="cpu", weights=str(path), **S_OPTIONS).num_sampling_points == 32


@pytest.mark.parametrize("name", ["robust_mvd", "robust_mvd_5M"])
def test_both_entries_take_the_jax_options(name):
    model = create_model(name, device="cpu", train=True, remat=False, corr_impl="pixelscan", **S_OPTIONS)
    assert (model.num_sampling_points, model.min_depth, model.max_depth) == (32, 0.5, 50.0)
    assert model.remat is False and model.corr_impl == CORR_IMPL
    assert create_model(name, device="cpu", dtype="bf16", corr_impl="matmul_bf16").corr_impl == CORR_IMPL


# --- corr_impl ---

def _jax_names():
    """The names JAX's planesweep_correlation_single dispatches on."""
    return set(re.findall(r'impl == "(\w+)"', inspect.getsource(jax_corr_module.planesweep_correlation_single)))


def test_every_jax_corr_impl_name_is_taken_or_refused_at_each_dtype():
    names = _jax_names()
    assert names == {"pixelscan", "pixelscan_bf16", "matmul", "matmul_bf16", "pallas", "gather"}
    for dtype in ("float32", "bfloat16"):
        refused = {name for d, name in CORR_REFUSED if d == dtype}
        assert set(CORR_TAKEN[dtype]) | refused == names and not set(CORR_TAKEN[dtype]) & refused, dtype


@pytest.mark.parametrize("dtype,name", [(d, n) for d in ("float32", "bfloat16") for n in sorted(_jax_names())])
def test_corr_impl_names(dtype, name):
    if name in CORR_TAKEN[dtype]:
        assert corr_impl_of(name, dtype) == CORR_IMPL
        return
    with pytest.raises(ValueError, match=f"corr_impl='{name}' at {dtype} .*; the port computes"):
        corr_impl_of(name, dtype)
    # create_model refuses it before building anything, at the model's dtype
    with pytest.raises(ValueError, match=f"corr_impl='{name}' at {dtype}"):
        create_model("robust_mvd", device="cpu", dtype=dtype, corr_impl=name)


def test_unknown_corr_impl_is_refused():
    with pytest.raises(ValueError, match="unknown corr_impl 'scan'"):
        create_model("robust_mvd", device="cpu", corr_impl="scan")
    with pytest.raises(ValueError, match="corr_impl='pallas' at bfloat16"):  # the model's own check
        RobustMVD(device="cpu", dtype="bf16", corr_impl="pallas")


@pytest.fixture(scope="module")
def corr_features():
    """Key and source features at robust_mvd's width C = 256, whose score
    scale 1/16 is a power of two (``tests/test_torch_port_bf16.py``'s)."""
    rng = np.random.RandomState(3)
    B, V, H, W, C = 1, 2, 6, 8, 256
    feat_key = rng.randn(B, H, W, C).astype(np.float32)
    feat_src = rng.randn(B, V, H, W, C).astype(np.float32)
    K = np.tile(K_REL, (B, 1, 1))
    Ks = np.tile(K[:, None], (1, V, 1, 1))
    Ts = np.stack([np.stack([random_pose(rng) for _ in range(V)]) for _ in range(B)])
    return feat_key, feat_src, K, Ks, Ts


TAKEN = [(d, n) for d in ("float32", "bfloat16") for n in CORR_TAKEN[d]]


@pytest.mark.parametrize("dtype,name", TAKEN)
def test_taken_corr_impl_matches_its_jax_route(corr_features, dtype, name):
    """The port's correlation at ``dtype`` against JAX's route ``name`` on the
    same features: float32 within 1e-5 ("pixelscan" 5e-3 of the largest
    |corr|, its epipole tolerance), bf16 within 1e-2 of it; masks equal but
    for at most 0.01% flipped on an exact pixel boundary."""
    feat_key, feat_src, K, Ks, Ts = corr_features
    kw = dict(num_sampling_points=32, min_depth=0.5, max_depth=50.0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    corr, mask, _ = planesweep_correlation(t(feat_key).to(tdt), t(feat_src).to(tdt), t(K), t(Ks), t(Ts), **kw)
    jcorr, jmask, _ = jax_corr(jnp.asarray(feat_key, jdt), jnp.asarray(feat_src, jdt), jnp.asarray(K),
                               jnp.asarray(Ks), jnp.asarray(Ts), impl=name, **kw)
    assert corr.dtype == tdt and jcorr.dtype == jdt
    corr, mask = corr.float().numpy(), mask.float().numpy()
    jcorr, jmask = np.asarray(jcorr, np.float32), np.asarray(jmask, np.float32)
    flips = np.argwhere(mask != jmask)
    assert len(flips) <= 1e-4 * mask.size, f"mask flips at (b, v, y, x, s): {flips.tolist()}"
    assert mask.mean() > 0.05  # the comparison is not vacuous
    same = mask == jmask
    if dtype == "bfloat16":
        np.testing.assert_allclose(corr[same], jcorr[same], rtol=0, atol=1e-2 * np.abs(jcorr).max())
    elif name == "pixelscan":
        np.testing.assert_allclose(corr[same], jcorr[same], rtol=0, atol=5e-3 * np.abs(jcorr).max())
    else:
        np.testing.assert_allclose(corr[same], jcorr[same], rtol=1e-5, atol=1e-5)


# --- JAX's TPU tiling options ---

@pytest.mark.parametrize("option", [{"slab_size": 32}, {"slab_size": None}, {"s2d": True}, {"s2d": False}],
                         ids=["slab_size", "slab_size_none", "s2d", "s2d_false"])
def test_tpu_tiling_options_are_refused(option):
    (name,) = option
    with pytest.raises(ValueError, match=f"^{name} sets .* the port has no counterpart"):
        create_model("robust_mvd", device="cpu", **option)


# --- the CLIs ---

def test_cli_flags_parse():
    args = train_parse_args(["--no_remat", "--num_gpus", "2"])
    assert args.no_remat is True and args.num_gpus == 2
    args = train_parse_args([])
    assert args.no_remat is False and args.num_gpus == 1
    for parse in (eval_parse_args, inference_parse_args):
        assert parse(["--num_gpus", "8"]).num_gpus == 8 and parse([]).num_gpus == 1
        with pytest.raises(SystemExit):  # as in JAX's, only the train CLI has --no_remat
            parse(["--no_remat"])


@pytest.mark.parametrize("name", ["robust_mvd", "robust_mvd_5M", "mvsnet_train"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("no_remat", [False, True])
def test_cli_model_kwargs_matches_jax(name, dtype, no_remat):
    try:
        expected = jax_cli_model_kwargs(name, dtype, no_remat)
    except SystemExit as exit_:
        with pytest.raises(SystemExit) as ours:
            cli_model_kwargs(name, dtype, no_remat)
        assert str(ours.value) == str(exit_)
        return
    assert cli_model_kwargs(name, dtype, no_remat) == expected


def test_train_cli_builds_the_model_without_remat_on_no_remat(monkeypatch, tmp_path):
    import robustmvd_tpu_torch.train.cli as cli

    built = []

    class Built(Exception):
        pass

    def capture(**kwargs):
        built.append(kwargs)
        raise Built

    monkeypatch.setattr(cli, "create_model", capture)
    base = ["--device", "cpu", "--dataset", "synthetic.train.mvd", "--model", "robust_mvd", "--loss",
            "robust_mvd_loss", "--max_iterations", "1", "--num_workers", "0", "--no_tensorboard"]
    for extra, output in (([], "default"), (["--no_remat"], "no_remat")):
        with pytest.raises(Built):
            cli.main(base + extra + ["--output", str(tmp_path / output)])
    assert built[0]["train"] is True and "remat" not in built[0]  # the default: remat = train
    assert built[1]["remat"] is False
