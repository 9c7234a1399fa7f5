"""The COCO-18 net in the port against islx's ``coco_forward`` (CPU): its
layers (the reference's doubled ``Mconv7_stage6_L1`` no-ReLU quirk: the
final heatmap head is ReLU-clamped), the forward in f32 within rtol/atol
1e-4 (the convolutions sum in another order) and in bf16 within 5e-2 of
the maps' largest magnitude (each conv rounds to bf16), the int8 forward
word-equal given islx's quantized params, the parity ``Body`` with the
COCO net, and the lifted refusals.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import PoseConfig as JPose
from islx.models import cpm as JC
from islx.models import quant as JQ
from islx.pose.body import Body as JBody
from islx_torch.core import weights as W
from islx_torch.core.config import PoseConfig
from islx_torch.models import cpm as TC
from islx_torch.pose.body import Body


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """islx's seeded full-width COCO params, the arm joints' final heat
    raised by 1 so that people form."""
    p = jax.tree.map(np.asarray, JC.init_params("coco",
                                                jax.random.PRNGKey(11)))
    b = np.array(p["Mconv7_stage6_L2"]["b"])
    b[2:8] += 1.0
    p["Mconv7_stage6_L2"]["b"] = b
    return p


def test_coco_spec_matches_islx():
    """Same layers in the same order, with islx's shapes, activations and
    heads; the port's init and weight carry-across cover every layer."""
    want = list(JC._iter_convs(JC.coco_spec()))
    got = TC.conv_layers("coco")
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]
    acts = {c.name: c.act for c in got}
    assert acts["Mconv7_stage6_L2"] == "relu"       # the reference's quirk
    assert acts["Mconv7_stage6_L1"] == acts["Mconv7_stage5_L2"] == "none"
    state = W.init_params("coco", 0)
    assert set(state) == {c.name for c in got}
    assert tuple(state["Mconv1_stage2_L1"]["w"].shape) == (128, 185, 7, 7)


def _x(seed=0, size=48):
    return (np.random.RandomState(seed).rand(2, size, size, 3)
            .astype(np.float32) - 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coco_forward_matches(params, dtype):
    """(paf [B,h,w,38], heat [B,h,w,19]) within the stated tolerance."""
    x = _x()
    want = jax.jit(lambda p, v: JC.coco_forward(p, v, getattr(jnp, dtype)))(
        params, jnp.asarray(x))
    net = W.build("coco", W.from_islx_params(params), torch.device("cpu"),
                  getattr(torch, dtype))
    with torch.inference_mode():
        got = net(torch.from_numpy(x), getattr(torch, dtype))
    for g, w, ch in zip(got, want, (38, 19)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert w.shape == (2, 6, 6, ch)
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(g.numpy() - w).max() <= 5e-2 * np.abs(w).max()
    assert (got[1][..., :18] >= 0).all()   # the ReLU-clamped final heat


def test_coco_int8_words_equal(params):
    """islx's quantized COCO params (calibrated by islx) carried across:
    every output word of the int8 forward equals islx's, f32 and bf16."""
    x = _x(1)
    q = jax.tree.map(np.asarray, JQ.quantize_model(params, "coco",
                                                   [_x(2)]))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jax.jit(lambda p, v: JC.FORWARDS["coco"](p, v, jdt))(
            q, jnp.asarray(x))
        net = W.build("coco", W.from_islx_params(q), torch.device("cpu"),
                      tdt)
        assert net.quantized
        with torch.inference_mode():
            got = net(torch.from_numpy(x), tdt)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                          np.asarray(w).view(np.uint32))


def test_coco_body_matches(params):
    """The parity Body with the COCO net on a 92x120 frame (scale 0.25):
    maps within rtol/atol 1e-4, then the same people."""
    frame = (np.random.RandomState(5).rand(92, 120, 3) * 255
             ).astype(np.uint8)
    pose = dict(scale_search=(0.25,), max_peaks=8, thre2=-0.5)
    jb = JBody(params, "coco", config=JPose(model_type="coco", **pose))
    tb = Body(W.from_islx_params(params), "coco",
              config=PoseConfig(model_type="coco", **pose), device="cpu")
    jheat, jpaf = jb.maps(frame)
    theat, tpaf = tb.maps(frame)
    assert theat.shape == (92, 120, 19) and tpaf.shape == (92, 120, 38)
    np.testing.assert_allclose(theat, jheat, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tpaf, jpaf, rtol=1e-4, atol=1e-4)
    thre1 = float(np.quantile(jheat[..., :18], 0.5))
    jb.cfg = dataclasses.replace(jb.cfg, thre1=thre1)
    tb.cfg = dataclasses.replace(tb.cfg, thre1=thre1)
    cand, subset = tb(frame)
    jcand, jsubset = jb(frame)
    np.testing.assert_array_equal(cand[:, [0, 1, 3]], jcand[:, [0, 1, 3]])
    np.testing.assert_allclose(cand[:, 2], jcand[:, 2], atol=1e-4)
    np.testing.assert_array_equal(subset[:, :-2], jsubset[:, :-2])
    assert subset.shape[1] == 20 and len(cand) > 18


def test_lifted_refusals(tmp_path, capsys):
    """coco builds where the net was the only reason to refuse it: the
    parity Body, the batched body pipeline, and the train and pose_train
    CLIs (which now fail later, on their empty inputs, not on the flag)."""
    from islx_torch.cli import pose_train as PCLI
    from islx_torch.cli import train as TCLI
    from islx_torch.pipeline.batch_pose import BatchedBodyPipeline

    assert Body(model_type="coco", device="cpu").limb_seq.shape == (19, 2)
    pipe = BatchedBodyPipeline(W.init_params("coco"), "coco", device="cpu")
    assert pipe.cfg.njoint == 19 and pipe.net.model_type == "coco"
    (tmp_path / "labels.csv").write_text("video_id,expression\n")
    (tmp_path / "data").mkdir()
    for main, argv in (
            (TCLI.main, [str(tmp_path), "--labels",
                         str(tmp_path / "labels.csv"), "--out",
                         str(tmp_path / "h.npz")]),
            (PCLI.main, [str(tmp_path / "data"), "--out",
                         str(tmp_path / "w.npz")])):
        with pytest.raises((SystemExit, ValueError, FileNotFoundError)):
            main(argv + ["--model-type", "coco", "--device", "cpu"])
        assert "not ported" not in capsys.readouterr().err
