""".caffemodel weights in the port (islx_torch.core.caffe_reader,
``weights.load``, the convert CLI and ``pose_train --init``) against islx's
reader and loader on the CPU.

The files are written here with a protobuf wire-format writer modelled on
islx's ``tests/test_components.py::TestCaffeReader``: new-style ``layer``
(field 100) and V1 ``layers`` (field 2) entries, packed and unpacked
floats, ``BlobShape`` dims packed and unpacked, the legacy
num/channels/height/width dims, layers without blobs and fields the
reader skips. Every comparison is exact: the same keys, and arrays equal
word for word.
"""
import struct

import numpy as np
import pytest
import torch

import jax

from islx.cli import convert as JCV
from islx.core import weights as JW
from islx.core.caffe_reader import read_caffemodel as j_read
from islx_torch.cli import convert as TCV
from islx_torch.cli import pose_train as PCLI
from islx_torch.core import weights as W
from islx_torch.core.caffe_reader import read_caffemodel as t_read
from islx_torch.models import cpm

# ---------------------------------------------------------------------------
# the writer


def varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        out += bytes([b7 | (0x80 if v else 0)])
        if not v:
            return out


def key(field: int, wire_type: int) -> bytes:
    return varint((field << 3) | wire_type)


def len_field(field: int, data: bytes) -> bytes:
    return key(field, 2) + varint(len(data)) + data


def blob(arr, dims: str = "packed", floats: str = "packed") -> bytes:
    """A BlobProto: dims "packed" / "unpacked" (BlobShape field 7, dim 1)
    or "legacy" (num/channels/height/width, fields 1-4, leading 1s);
    floats "packed" (one field 5) or "unpacked" (a fixed32 field 5 a
    value)."""
    arr = np.asarray(arr, "<f4")
    if dims == "packed":
        out = len_field(7, len_field(1, b"".join(varint(d)
                                                 for d in arr.shape)))
    elif dims == "unpacked":
        out = len_field(7, b"".join(key(1, 0) + varint(d)
                                    for d in arr.shape))
    else:
        shape = (1,) * (4 - arr.ndim) + arr.shape
        out = b"".join(key(f, 0) + varint(d)
                       for f, d in zip((1, 2, 3, 4), shape))
    if floats == "packed":
        return out + len_field(5, arr.tobytes())
    return out + b"".join(key(5, 5) + struct.pack("<f", v)
                          for v in arr.ravel())


def layer(name: str, blobs, v1: bool = False, type_: str = "Convolution"
          ) -> bytes:
    """A LayerParameter (name 1, type 2, blobs 7) or a V1LayerParameter
    (name 4, type enum 5, blobs 6)."""
    if v1:
        out = len_field(4, name.encode()) + key(5, 0) + varint(4)
    else:
        out = len_field(1, name.encode()) + len_field(2, type_.encode())
    return out + b"".join(len_field(6 if v1 else 7, b) for b in blobs)


def caffemodel(layers) -> bytes:
    """NetParameter: a name, then ``(v1, layer bytes)`` entries."""
    return len_field(1, b"net") + b"".join(
        len_field(2 if v1 else 100, lb) for v1, lb in layers)


def seeded_state(model_type: str, seed: int) -> W.State:
    """Full-width weights, biases and PReLU slopes, all drawn from a
    seeded numpy generator."""
    rng = np.random.default_rng(seed)
    state = {}
    for c in cpm.conv_layers(model_type):
        e = {"w": rng.standard_normal((c.cout, c.cin, c.k, c.k),
                                      dtype=np.float32) * 0.05,
             "b": rng.standard_normal(c.cout, dtype=np.float32) * 0.1}
        if c.act == "prelu":
            e["p"] = rng.random(c.cout, dtype=np.float32)
        state[c.name] = {k: torch.from_numpy(v) for k, v in e.items()}
    return state


def write_state(path: str, state: W.State) -> None:
    """A state as an OpenPose-style .caffemodel: every third conv a V1
    layer with legacy weight dims, the others new-style with packed or
    unpacked BlobShape dims; PReLU slopes as single-blob layers; a ReLU
    layer without blobs after each ReLU conv."""
    flat = W.to_flat_dict(state)
    layers = []
    for i, (name, entry) in enumerate(state.items()):
        w, b = flat[f"{name}.weight"], flat[f"{name}.bias"]
        if i % 3 == 0:
            layers.append((True, layer(name, [blob(w, "legacy"), blob(b)],
                                       v1=True)))
        else:
            dims = "packed" if i % 3 == 1 else "unpacked"
            layers.append((False, layer(name, [blob(w, dims),
                                               blob(b, dims)])))
        if "p" in entry:
            pk = W._prelu_key(name)
            layers.append((False, layer(pk, [blob(flat[f"{pk}.weight"])],
                                        type_="PReLU")))
        else:
            layers.append((False, layer(f"relu_{name}", [], type_="ReLU")))
    with open(path, "wb") as f:
        f.write(caffemodel(layers))


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    """Full-width .caffemodel files of the three nets, written on first
    use: model type -> (path, the state written)."""
    d = tmp_path_factory.mktemp("caffe")
    made = {}

    def get(model_type):
        if model_type not in made:
            state = seeded_state(model_type, {"body25": 1, "coco": 2,
                                              "hand": 3}[model_type])
            path = str(d / f"{model_type}.caffemodel")
            write_state(path, state)
            made[model_type] = path, state
        return made[model_type]

    return get


def _same_flat(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _same_state(got, want):
    assert set(got) == set(want)
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for k in want[name]:
            assert got[name][k].dtype == want[name][k].dtype, (name, k)
            assert torch.equal(got[name][k], want[name][k]), (name, k)


def test_reader_matches_islx(tmp_path):
    """Every encoding the reader knows, in one file, against islx's
    reader: the same keys, byte-equal arrays; and the values written."""
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    w2 = rng.randn(2, 4, 1, 1).astype(np.float32)
    slope = rng.rand(4).astype(np.float32)
    fc = rng.randn(5, 6).astype(np.float32)
    junk = key(9, 1) + b"\0" * 8 + key(10, 5) + b"\0" * 4  # I64, I32
    layers = [
        (False, layer("conv1", [blob(w), blob(b)])),           # new-style
        (False, layer("relu1", [], type_="ReLU")),             # no blobs
        (False, layer("prelu1", [blob(slope, "unpacked")], type_="PReLU")),
        (True, layer("conv2", [blob(w2, "legacy"),             # V1, legacy
                               blob(b[:2], "legacy")], v1=True)),
        (False, layer("fc", [blob(fc, "unpacked", "unpacked"),
                             blob(b, "packed", "unpacked")]) + junk),
        (True, layer("", [blob(b)], v1=True)),                 # no name
    ]
    path = str(tmp_path / "mixed.caffemodel")
    with open(path, "wb") as f:
        f.write(caffemodel(layers) + junk)
    got, want = t_read(path), j_read(path)
    _same_flat(got, want)
    assert list(got) == ["conv1.weight", "conv1.bias", "prelu1.weight",
                         "conv2.weight", "conv2.bias", "fc.weight",
                         "fc.bias"]
    np.testing.assert_array_equal(got["conv1.weight"], w)
    np.testing.assert_array_equal(got["prelu1.weight"], slope)
    np.testing.assert_array_equal(got["conv2.weight"], w2)
    assert got["conv2.bias"].shape == (1, 1, 1, 2)     # legacy dims
    np.testing.assert_array_equal(got["fc.weight"], fc)
    np.testing.assert_array_equal(got["fc.bias"], b)


@pytest.mark.parametrize("model_type", ["body25", "coco", "hand"])
def test_load_caffemodel_full_width(full_width, model_type):
    """``W.load(x.caffemodel)`` equals islx's ``W.load`` of the same file
    carried across, word for word, and the weights written."""
    path, state = full_width(model_type)
    got = W.load(path, model_type)
    want = W.from_islx_params(jax.tree.map(np.asarray,
                                           JW.load(path, model_type)))
    _same_state(got, want)
    _same_state(got, state)


def test_convert_caffemodel_matches_islx(full_width, tmp_path, capsys):
    """The port's .npz from a .caffemodel loads in islx's ``W.load``
    equal to islx's own conversion of the same file; a wrong model type
    fails the layer check."""
    path, _ = full_width("hand")
    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    TCV.main([path, ours, "--model-type", "hand"])
    assert "params, verified" in capsys.readouterr().out
    JCV.main([path, theirs, "--model-type", "hand"])
    got, want = JW.load(ours, "hand"), JW.load(theirs, "hand")
    assert got.keys() == want.keys()
    for name in want:
        for k in want[name]:
            np.testing.assert_array_equal(np.asarray(got[name][k]),
                                          np.asarray(want[name][k]))
    with pytest.raises(KeyError):
        TCV.main([path, str(tmp_path / "x.npz"), "--model-type", "body25"])


def test_convert_other_sources(tmp_path):
    """.pt flat dicts, .npz and the port's state files convert too; the
    parameter count is checked; an int8 state is refused."""
    state = seeded_state("hand", 4)
    pt = str(tmp_path / "w.pt")
    torch.save({k: torch.from_numpy(v) for k, v in
                W.to_flat_dict(state).items()}, pt)
    W.save_state(str(tmp_path / "s.pt"), state, "hand")
    for src in (pt, str(tmp_path / "s.pt")):
        out = str(tmp_path / "o.npz")
        TCV.main([src, out, "--model-type", "hand"])
        _same_state(W.load(out, "hand"), state)
        TCV.main([out, str(tmp_path / "o2.npz"), "--model-type", "hand"])
        _same_state(W.load(str(tmp_path / "o2.npz"), "hand"), state)
    q = dict(state)
    q["conv1_1"] = {"w_q": torch.zeros(64, 3, 3, 3, dtype=torch.int8),
                    "s_w": torch.ones(64), "a_scale": torch.tensor(1.0),
                    "b": state["conv1_1"]["b"]}
    W.save_state(str(tmp_path / "q.pt"), q, "hand")
    with pytest.raises(SystemExit):
        TCV.main([str(tmp_path / "q.pt"), str(tmp_path / "q.npz"),
                  "--model-type", "hand"])


def test_state_files_round_trip_and_check_their_net(tmp_path):
    """``save_state`` writes exactly ``path``, which must end in ``.pt``;
    ``load`` reads it back and refuses another net's state."""
    state = seeded_state("hand", 5)
    out = str(tmp_path / "a.pt")
    assert W.save_state(out, state, "hand") == out
    _same_state(W.load(out, "hand"), state)
    with pytest.raises(ValueError, match="hand state"):
        W.load(out, "body25")
    with pytest.raises(ValueError, match=r"ends in \.pt"):
        W.save_state(str(tmp_path / "b"), state, "hand")
    assert not (tmp_path / "b").exists()
    assert not (tmp_path / "b.pt").exists()


def test_pose_train_init_from_caffemodel(full_width, tmp_path):
    """One pose_train step from a .caffemodel init equals the step from
    the same weights given as .npz, word for word."""
    path, state = full_width("hand")
    d = tmp_path / "ds"
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        np.savez(d / f"s{i}.npz",
                 image=(rng.rand(24, 24, 3) * 255).astype(np.uint8),
                 keypoints=rng.rand(21, 2).astype(np.float32) * 20 + 2,
                 visible=rng.rand(21) > 0.2)
    npz = str(tmp_path / "init.npz")
    W.save_npz(npz, state)
    outs = []
    for init in (path, npz):
        out = str(tmp_path / f"out{len(outs)}.npz")
        PCLI.main([str(d), "--model-type", "hand", "--epochs", "1",
                   "--batch", "2", "--size", "24", "--init", init,
                   "--out", out, "--device", "cpu"])
        outs.append(W.load(out, "hand"))
    _same_state(outs[0], outs[1])
    assert not torch.equal(outs[0]["conv1_1"]["w"], state["conv1_1"]["w"])
