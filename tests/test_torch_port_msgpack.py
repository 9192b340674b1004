"""JAX's msgpack weights in the port, and aux returned lazily.

- A snapshot written by the JAX package's own ``WeightsOnlySaver`` (a
  robust_mvd at S = 8; JAX's variables come from its converter of the
  port's seeded ``.pt``, which needs no JAX init) loads through the port's
  ``load_robust_mvd_weights`` into a state_dict bit-equal to
  ``state_dict_from_jax`` of the JAX variables. One forward of each package,
  each loaded from that file (JAX through ``flax.serialization.from_bytes``,
  as its loader does), agrees within ``tests/test_torch_port_model.py``'s
  ``BOUNDS["matmul"]`` (64x128, key + 2 source views).
- The decoder (``utils/flax_msgpack.py``) equals ``msgpack.unpackb`` with
  flax's ext hook on hypothesis-made trees (nested maps and arrays, every int
  and float width, numpy leaves of float32, int32, uint8 and bfloat16, numpy
  scalars, complex numbers) and on str, bin, array and map lengths across
  their headers' widths; bfloat16 leaves come back as ``torch.bfloat16``.
- Chunked leaves (flax's ``MAX_CHUNK_SIZE`` monkeypatched to 300 bytes) are
  rejoined exactly.
- A fresh interpreter in which ``msgpack``, ``flax``, ``jax`` and
  ``robustmvd_tpu`` cannot be imported loads the snapshot.
- Malformed and truncated input raises ``ValueError``.
- ``robust_mvd_5M`` and the eval CLI's ``--weights`` take a JAX snapshot.
- Lazy aux: the four native models return aux as a ``LazyNumpyDict``; every
  way of reading it gives numpy, and equals the eager copy; the evaluation
  copies only pred to the host.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import flax.serialization
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from ml_dtypes import bfloat16

from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.utils.checkpoint import WeightsOnlySaver
from robustmvd_tpu_torch import create_dataset, create_evaluation, create_model
from robustmvd_tpu_torch.eval import cli as eval_cli
from robustmvd_tpu_torch.models import helpers
from robustmvd_tpu_torch.models.helpers import LazyNumpyDict
from robustmvd_tpu_torch.models.robust_mvd import load_robust_mvd_weights
from robustmvd_tpu_torch.models.weights import state_dict_from_jax
from robustmvd_tpu_torch.utils import flax_msgpack, to_numpy
from test_torch_port_model import BOUNDS, _check

from torch_port_helpers import mvd_sample, torch_threads

ROOT = Path(__file__).resolve().parents[1]


def jax_snapshot(directory, seed, **options):
    """The port's seeded robust_mvd as the JAX package saves it: its ``.pt``
    read by JAX's ``create_model(weights=...)`` (the converter, no init),
    the variables written by JAX's ``WeightsOnlySaver``. Returns (msgpack
    path, JAX model, port model)."""
    port = create_model("robust_mvd", device="cpu", seed=seed, **options)
    pt = os.path.join(directory, "port.pt")
    torch.save({"model_state_dict": port.state_dict()}, pt)
    jax_model = jax_create_model("robust_mvd", weights=pt, corr_impl="matmul", **options)
    path = WeightsOnlySaver(directory).save(jax_model.variables, 10)
    return path, jax_model, port


def digest(state):
    h = hashlib.sha256()
    for key, value in state.items():
        h.update(key.encode() + value.numpy().tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def s8(tmp_path_factory):
    return jax_snapshot(str(tmp_path_factory.mktemp("s8")), seed=3, num_sampling_points=8)


@pytest.fixture(scope="module")
def s256(tmp_path_factory):
    return jax_snapshot(str(tmp_path_factory.mktemp("s256")), seed=4)


def test_jax_snapshot_loads_bit_equal_to_the_bridge(s8):
    path, jax_model, port = s8
    assert path.endswith("snapshot-iter-000000010.msgpack")
    ours, ref = load_robust_mvd_weights(path), state_dict_from_jax(jax_model.variables)
    assert set(ours) == set(ref) == set(port.state_dict())
    for key, value in ref.items():
        assert ours[key].dtype == torch.float32 and torch.equal(ours[key], value), key
        assert torch.equal(ours[key], port.state_dict()[key]), key


def test_forward_from_the_snapshot_matches_jax(s8):
    path, jax_model, _ = s8
    with open(path, "rb") as f:
        jax_model.variables = flax.serialization.from_bytes(jax_model.variables, f.read())
    sample = mvd_sample(np.random.RandomState(7), 64, 128, num_views=3)
    ref_pred, ref_aux = jax_model.run(**sample)
    with torch_threads(2):
        port = create_model("robust_mvd", device="cpu", weights=path, num_sampling_points=8)
        pred, aux = port.run(**sample)
    for key in ("invdepths_all", "invdepth_log_bs_all"):
        for scale, (o, r) in enumerate(zip(aux[key], ref_aux[key])):
            _check(o, np.asarray(r), BOUNDS["matmul"], f"{key}[{scale}]")
    invdepth = np.asarray(ref_aux["invdepth"])
    assert (invdepth > 0).mean() > 0.2  # the comparison is not vacuous
    rel = np.abs(pred["depth"] - ref_pred["depth"]) / ref_pred["depth"]
    assert rel[invdepth > 0].mean() <= BOUNDS["matmul"][0]


def test_bfloat16_snapshot_is_widened_exactly(s8, tmp_path):
    """A snapshot of bfloat16 leaves: read as torch.bfloat16, widened to
    float32 exactly, as ``state_dict_from_jax`` widens ml_dtypes' arrays."""
    import jax

    variables = jax.tree_util.tree_map(lambda x: np.asarray(x).astype(bfloat16), s8[1].variables)
    path = tmp_path / "bf16.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(variables))
    ours, ref = load_robust_mvd_weights(str(path)), state_dict_from_jax(variables)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert ours[key].dtype == torch.float32 and torch.equal(ours[key], value), key
        assert torch.equal(value, s8[2].state_dict()[key].bfloat16().float()), key


def test_snapshot_of_another_s_is_refused(s8):
    with pytest.raises(ValueError, match="num_sampling_points=8"):
        create_model("robust_mvd", device="cpu", weights=s8[0])


# --- the decoder against msgpack.unpackb with flax's ext hook ---------------

def same(ours, ref):
    """Structural equality; arrays by dtype, shape and bytes (bfloat16: the
    port's torch.bfloat16 against ml_dtypes' bits)."""
    if isinstance(ref, dict):
        return isinstance(ours, dict) and list(ours) == list(ref) and all(same(ours[k], ref[k]) for k in ref)
    if isinstance(ref, list):
        return isinstance(ours, list) and len(ours) == len(ref) and all(map(same, ours, ref))
    if isinstance(ref, (np.ndarray, np.generic)) and ref.dtype == bfloat16:
        return (isinstance(ours, torch.Tensor) and ours.dtype == torch.bfloat16
                and np.array_equal(ours.view(torch.int16).numpy().view(np.uint16), np.asarray(ref).view(np.uint16)))
    if isinstance(ref, (np.ndarray, np.generic)):
        return type(ours) is type(ref) and ours.dtype == ref.dtype and np.asarray(ours).tobytes() == np.asarray(
            ref).tobytes() and np.shape(ours) == np.shape(ref)
    if isinstance(ref, float) and np.isnan(ref):
        return isinstance(ours, float) and np.isnan(ours)
    return type(ours) is type(ref) and ours == ref


def unpack_like_flax(data):
    return msgpack.unpackb(data, ext_hook=flax.serialization._msgpack_ext_unpack, raw=False)


def pack_like_flax(tree, single_float=False):
    return msgpack.packb(tree, default=flax.serialization._msgpack_ext_pack, strict_types=True,
                         use_single_float=single_float)


def arrays(dtype):
    shapes = st.lists(st.integers(0, 4), max_size=3)
    return shapes.flatmap(lambda shape: st.binary(min_size=int(np.prod(shape)) * np.dtype(dtype).itemsize,
                                                  max_size=int(np.prod(shape)) * np.dtype(dtype).itemsize).map(
        lambda raw: np.frombuffer(raw, dtype).reshape(shape).copy()))


scalars = (st.none() | st.booleans() | st.integers(-(2**63), 2**64 - 1) | st.floats(allow_nan=True)
           | st.text(max_size=40) | st.binary(max_size=300)
           | st.complex_numbers(allow_nan=False, allow_infinity=False)
           | st.floats(width=32).map(np.float32) | st.integers(-(2**31), 2**31 - 1).map(np.int32)
           | arrays(np.float32) | arrays(np.int32) | arrays(np.uint8) | arrays(bfloat16))
trees = st.recursive(scalars, lambda inner: st.lists(inner, max_size=5) | st.dictionaries(st.text(max_size=8), inner,
                                                                                         max_size=20),
                     max_leaves=30)


@settings(max_examples=60, deadline=None, database=None)
@given(tree=st.dictionaries(st.text(max_size=8), trees, max_size=20), single_float=st.booleans())
def test_decoder_equals_msgpack_unpackb(tree, single_float):
    data = pack_like_flax(tree, single_float)
    assert same(flax_msgpack.msgpack_restore(data), unpack_like_flax(data))


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_decoder_reads_every_header_width(n):
    tree = {"str": "x" * n, "bin": b"\x07" * n, "array": list(range(n)), "map": {str(i): i for i in range(n)},
            "leaf": np.arange(n, dtype=np.uint8)}
    data = pack_like_flax(tree)
    assert same(flax_msgpack.msgpack_restore(data), unpack_like_flax(data))


def test_chunked_leaves_are_rejoined(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 300)
    rng = np.random.RandomState(0)
    tree = {"params": {"a": rng.randn(10, 100).astype(np.float32), "b": rng.randn(7, 71).astype(bfloat16),
                       "c": np.arange(5, dtype=np.int32)}}
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    ours, ref = flax_msgpack.msgpack_restore(data), flax.serialization.msgpack_restore(data)
    assert same(ours, ref)
    assert np.array_equal(ours["params"]["a"], tree["params"]["a"])


# --- malformed input --------------------------------------------------------

GOOD = pack_like_flax({"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}})
MALFORMED = {
    "empty": b"",
    "truncated_header": GOOD[:1],
    "truncated_key": GOOD[:5],
    "truncated_leaf": GOOD[:-3],
    "trailing_bytes": GOOD + b"\x00",
    "reserved_type_byte": b"\xc1",
    "unknown_ext_code": pack_like_flax({"w": msgpack.ExtType(5, b"abc")}),
    "int_map_key": msgpack.packb({1: 2}),
    "unknown_dtype": pack_like_flax({"w": msgpack.ExtType(1, msgpack.packb(((2,), "float8_e9", b"ab")))}),
    "short_buffer": pack_like_flax({"w": msgpack.ExtType(1, msgpack.packb(((3,), "float32", b"\x00" * 8)))}),
    "object_dtype": pack_like_flax({"w": msgpack.ExtType(1, msgpack.packb(((1,), "object", b"\x00" * 8)))}),
    "not_utf8": b"\xa2\xff\xfe",
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_input_raises_value_error(case):
    with pytest.raises(ValueError):
        flax_msgpack.msgpack_restore(MALFORMED[case])


def test_a_file_without_params_is_refused(tmp_path):
    path = tmp_path / "tree.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize({"weights": {"w": np.zeros(2, np.float32)}}))
    with pytest.raises(ValueError, match=r"expected flax variables \{'params': \.\.\.\}, found \['weights'\]"):
        load_robust_mvd_weights(str(path))


# --- the card has no msgpack -------------------------------------------------

def test_loads_where_msgpack_flax_and_jax_cannot_be_imported(s8, tmp_path):
    code = """
import sys
for name in ("msgpack", "flax", "jax", "robustmvd_tpu"):
    sys.modules[name] = None
import hashlib
import torch
torch.set_num_threads(1)
import robustmvd_tpu_torch as r
model = r.create_model("robust_mvd", device="cpu", weights=sys.argv[1], num_sampling_points=8)
h = hashlib.sha256()
for key, value in model.state_dict().items():
    h.update(key.encode() + value.numpy().tobytes())
print("DIGEST", h.hexdigest())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, s8[0]], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"DIGEST {digest(s8[2].state_dict())}" in out.stdout


# --- robust_mvd_5M and the eval CLI -------------------------------------------

def test_robust_mvd_5m_takes_a_jax_snapshot(s256):
    model = create_model("robust_mvd_5M", device="cpu", weights=s256[0])
    assert digest(model.state_dict()) == digest(s256[2].state_dict())


def test_eval_cli_takes_a_jax_snapshot(s256, tmp_path, monkeypatch):
    built = []

    def spy(*args, **kwargs):
        built.append(create_model(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(eval_cli, "create_model", spy)
    with torch_threads(2):
        eval_cli.main(["--device", "cpu", "--eval_type", "mvd", "--dataset", "synthetic.train.mvd", "--model",
                       "robust_mvd", "--weights", s256[0], "--inputs", "poses", "intrinsics", "--num_samples", "1",
                       "--max_source_views", "1", "--num_qualitatives", "0", "--no_tensorboard",
                       "--output", str(tmp_path)])
    assert len(built) == 1 and digest(built[0].state_dict()) == digest(s256[2].state_dict())
    assert (tmp_path / "log.txt").exists()


# --- lazy aux ------------------------------------------------------------------

@pytest.fixture(scope="module")
def robust_mvd_output(s8):
    model = s8[2]
    adapted = model.input_adapter(**mvd_sample(np.random.RandomState(1), 64, 64, num_views=2))
    with torch.inference_mode(), torch_threads(2):
        return model(**adapted), model


READS = {
    "getitem": lambda aux: [aux[k] for k in aux.keys()],
    "get": lambda aux: [aux.get(k) for k in aux.keys()],
    "items": lambda aux: [v for _, v in aux.items()],
    "values": lambda aux: aux.values(),
    "dict": lambda aux: list(dict(aux).values()),
    "unpack": lambda aux: list({**aux}.values()),
    "copy": lambda aux: list(aux.copy().values()),
    "or": lambda aux: list((aux | {}).values()),
    "pop": lambda aux: [aux.pop(k) for k in list(aux.keys())],
    "setdefault": lambda aux: [aux.setdefault(k) for k in aux.keys()],
}


def numpy_leaves(value):
    if isinstance(value, dict):
        return [x for v in value.values() for x in numpy_leaves(v)]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in numpy_leaves(v)]
    return [value]


@pytest.mark.parametrize("read", sorted(READS))
def test_every_read_of_aux_gives_numpy(robust_mvd_output, read):
    output, model = robust_mvd_output
    pred, aux = model.output_adapter(output)
    eager_pred, eager_aux = to_numpy(output)
    assert isinstance(aux, LazyNumpyDict)
    assert all(isinstance(dict.__getitem__(aux, k), (torch.Tensor, list)) for k in aux.keys())  # not yet copied
    for k, v in pred.items():
        assert isinstance(v, np.ndarray) and np.array_equal(v, eager_pred[k])
    values = READS[read](aux)
    assert len(values) == len(eager_aux)
    for value, ref in zip(values, eager_aux.values()):
        leaves, refs = numpy_leaves(value), numpy_leaves(ref)
        assert all(isinstance(x, np.ndarray) for x in leaves) and len(leaves) == len(refs)
        assert all(np.array_equal(x, y) for x, y in zip(leaves, refs))


@pytest.mark.parametrize("name, kwargs", [("robust_mvd", {"num_sampling_points": 8}), ("mvsnet_train", {}),
                                          ("cvp_mvsnet", {"nscale": 3}), ("vis_mvsnet", {})])
def test_native_models_return_aux_lazily(name, kwargs):
    """Batched, aux comes back lazy; unbatched, removing the batch dim reads
    every value (as in JAX, whose ``remove_batch_dim`` reads ``items()``)."""
    sample = mvd_sample(np.random.RandomState(2), 64, 64, num_views=2)
    unbatched = {"images": [img[0] for img in sample["images"]], "poses": [p[0] for p in sample["poses"]],
                 "intrinsics": [k[0] for k in sample["intrinsics"]], "keyview_idx": 0}
    with torch_threads(2):
        model = create_model(name, device="cpu", **kwargs)
        pred, aux = model.run(**sample)
        assert isinstance(aux, LazyNumpyDict) and not aux._done
        runs = [(pred, dict(aux)), model.run(**unbatched)]
    for pred, aux in runs:
        for value in [*pred.values(), *aux.values()]:
            assert all(isinstance(x, np.ndarray) for x in numpy_leaves(value)), name
    assert runs[1][0]["depth"].shape == runs[0][0]["depth"].shape[1:]


def test_the_evaluation_copies_only_pred(s8, monkeypatch):
    converted = []

    def counting(data):
        converted.append(sorted(data) if isinstance(data, dict) else type(data).__name__)
        return to_numpy(data)

    monkeypatch.setattr(helpers, "to_numpy", counting)
    dataset = create_dataset("synthetic.train.mvd", num_samples=1, num_views=3, height=64, width=64)
    evaluation = create_evaluation("mvd", inputs=["poses", "intrinsics"], view_ordering="nearest", verbose=False)
    with torch_threads(2):
        results = evaluation(dataset=dataset, model=s8[2], qualitatives=0)
    assert np.isfinite(results["best"]["absrel"]).all()
    assert converted and all(c == ["depth", "depth_uncertainty"] for c in converted), converted
