"""The port's multi-device code on the CPU against islx's.

islx runs on the 8 virtual CPU devices that tests/conftest.py sets up; the
port runs on a mesh of 8 copies of the CPU device, with its kernels'
plain versions. A mesh of repeated devices exercises the split,
placement and gather logic, not transfers. Inputs are seeded numpy
arrays, weights are islx's or the port's seeded ones carried across
(``core/weights.py::from_islx_params``, ``models/translator.py::
from_islx_params``).

Tolerances, and why:
- the sharded head's forward: 2e-5 (islx's own, tests/test_parallel.py);
- the sharded and tensor-parallel train step against the port's
  unsharded step: the loss within 1e-5 relative; every weight within 1e-5
  relative where the unsharded gradient is not within 1e-6 of zero
  (Adam's first step is about ``-lr * sign(g)``, so a gradient inside
  rounding of zero may move 2*lr apart; the rows' gradients are summed in
  another order); the BN statistics' EMA within 1e-4 relative (atol 1e-6:
  means near 0); against islx's sharded step with dropout off, as
  tests/test_torch_train.py holds the unsharded step: 1e-6 where the
  gradient is not within 1e-6 of zero;
- CPM forwards: 1e-4 (batched, spatial), 1e-5 (pipelined), as islx's;
- pipelined gradients: rtol 1e-4, atol 1e-5 (islx's);
- the fused step: integer planes word-equal, floats within 1e-4; crops
  gathered across shards exact;
- a pose-train step on a mesh: the loss within 1e-5 relative, every
  gradient and Adam first moment within 1e-4 relative (atol 1e-7: the
  rows' gradients are summed in another order), parameters as the head's
  step.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import HandConfig as JHand
from islx.core.config import PoseConfig as JPose
from islx.core.config import TranslatorConfig as JCfg
from islx.isl import train as JTR
from islx.models import cpm as JC
from islx.models import translator as JT
from islx.parallel import mesh as JM
from islx.parallel import sharding as JS
from islx.pipeline import batch_pose as JBP
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig, TranslatorConfig
from islx_torch.isl import train as TR
from islx_torch.models import cpm
from islx_torch.models import pose_train as PT
from islx_torch.models import translator as T
from islx_torch.ops.resize import dynamic_crop_resize_batch
from islx_torch.parallel import mesh as M
from islx_torch.parallel import sharding as S
from islx_torch.parallel.pipeline import PipelinedCPM
from islx_torch.pipeline import batch_pose as TBP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, jax.devices()
    return JM.make_mesh(n_data=4, n_model=2)


@pytest.fixture(scope="module")
def tmesh():
    return M.make_mesh(n_data=4, n_model=2, devices=CPU8)


def windows(seed, n):
    """Seeded windows with zero-padded tails of 0-12 steps, and labels."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 20, 156).astype(np.float32)
    for i, keep in enumerate(rng.randint(8, 21, n)):
        x[i, keep:] = 0.0
    return x, rng.randint(0, 167, n).astype(np.int32)


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def test_mesh_shapes(jmesh, tmesh):
    assert tmesh.shape == jmesh.shape == {"data": 4, "model": 2}
    assert tmesh.axis_names == (M.DATA_AXIS, M.MODEL_AXIS) == ("data",
                                                              "model")
    assert M.make_mesh(devices=CPU8[:6], n_model=3).shape == {"data": 2,
                                                              "model": 3}
    x = torch.arange(8 * 3).reshape(8, 3)
    shards = M.batch_sharding(tmesh).put(x)
    assert [s.shape[0] for s in shards] == [2, 2, 2, 2]
    assert torch.equal(M.batch_sharding(tmesh).gather(shards), x)
    frames = torch.arange(4 * 2 * 44 * 3).reshape(4, 2, 44, 3)
    stripes = M.spatial_sharding(tmesh).put(frames)
    assert [[s.shape[2] for s in row] for row in stripes] == [[24, 20]] * 4
    assert torch.equal(M.spatial_sharding(tmesh).gather(stripes), frames)
    assert M.stripe_bounds(64, 2) == [(0, 32), (32, 64)]
    state = W.init_params("hand", 0)
    copies = M.shard_cpm_params(state, tmesh)
    assert len(copies) == 4 and len({id(c) for c in copies}) == 4
    assert torch.equal(copies[3]["conv1_1"]["w"], state["conv1_1"]["w"])
    assert M.replicated(tmesh).gather(copies) is copies[0]
    grid = M.replicate(tmesh, lambda d: object(), first=state, grid=True)
    assert grid[0][0] is state and len({id(c) for r in grid for c in r}) == 8
    assert M.single("cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="not divisible"):
        M.batch_sharding(tmesh).put(x[:6])
    with pytest.raises(ValueError, match="mixes"):
        M.Mesh(np.array([[torch.device("cpu"), torch.device("meta")]],
                        dtype=object))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_mesh()


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|islx)\b(?!_torch)"
                        r"|from\s+(jax|islx)(\.|\s)(?!.*islx_torch))",
                        re.MULTILINE)


def test_parallel_modules_exist_and_import_no_jax():
    for name in ("mesh", "sharding", "pipeline"):
        with open(os.path.join(REPO, "islx_torch", "parallel",
                               f"{name}.py")) as f:
            src = f.read()
        assert not _FORBIDDEN.search(src), name
    with open(os.path.join(REPO, "islx_torch", "pipeline",
                           "batch_pose.py")) as f:
        assert "item 8" not in f.read()


def test_translator_param_specs_are_islx_rules(tmesh, jmesh):
    params = T.init_params(TranslatorConfig(), 0)
    got = M.translator_param_shardings(params, tmesh)
    want = JM.translator_param_shardings(params, jmesh)
    for name in params:
        for k in params[name]:
            assert got[name][k] == tuple(want[name][k].spec), (name, k)
    assert got["lstm1_fwd"]["kernel"] == (None, "model")
    assert got["dense3"]["kernel"] == ()


def test_sharded_head_forward_matches_islx(jmesh, tmesh):
    params = jax.tree.map(np.asarray, JT.init_params(JCfg()))
    x, _ = windows(0, 8)
    want = np.asarray(jax.jit(JT.forward)(params, jnp.asarray(x)))
    sharded = JM.shard_translator_params(params, jmesh)
    want_mesh = np.asarray(jax.jit(JT.forward)(
        sharded, jax.device_put(jnp.asarray(x), JM.batch_sharding(jmesh))))
    head = M.shard_translator_params(params, tmesh)
    assert head.split_dim("lstm1_fwd", "recurrent") == 1
    assert len(head.parts("lstm2_bwd", "kernel")) == 2
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, want_mesh, atol=2e-5)
    assert head.to_params()["lstm1_fwd"]["kernel"].shape == (156, 128)


def _params_close(got, want, flat_grads, rtol, atol):
    """Every weight within rtol/atol where its reference gradient is not
    within 1e-6 of zero (2*lr there); statistics within 1e-4 relative."""
    for name in want:
        for k in want[name]:
            g, w = got[name][k], want[name][k]
            if name.startswith("bn") and k in ("mean", "var"):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{name}/{k}")
                continue
            flip = np.abs(flat_grads[f"{name}__{k}"]) <= 1e-6
            err = np.abs(g - w)
            assert (err <= atol + rtol * np.abs(w) + 2e-3 * flip).all(), \
                (name, k, err.max())


def test_sharded_tp_train_step(jmesh, tmesh):
    """n_data=4, n_model=2: one step with dropout on against the port's
    unsharded step on the same generator (BN over the global batch, one
    dropout mask), then with dropout off against islx's sharded step."""
    params = jax.tree.map(np.asarray, JT.init_params(JCfg()))
    x, y = windows(1, 16)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    cfg = TranslatorConfig()
    one = TR.init_state(cfg, 1e-3, params, device="cpu")
    many = TR.init_state(cfg, 1e-3, params, device="cpu")
    m1 = TR.make_train_step(one)(xt, yt, torch.Generator().manual_seed(7))
    m2 = TR.make_train_step(many, tmesh)(xt, yt,
                                         torch.Generator().manual_seed(7))
    assert many.head.mesh is tmesh and one.head.mesh is None
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    grads = {n: p.grad.numpy() for n, p in one.head.named_parameters()}
    _params_close(many.head.to_params(), one.head.to_params(), grads,
                  1e-5, 1e-7)
    # the parts' moments are the whole head's, split
    back = TR.shard_state(many)
    for n, p in back.head.named_parameters():
        want = one.optimizer.state[dict(one.head.named_parameters())[n]]
        np.testing.assert_allclose(back.optimizer.state[p]["exp_avg"],
                                   want["exp_avg"], rtol=1e-3, atol=1e-8)

    cfg0 = TranslatorConfig(dropout=0.0)
    jcfg = JCfg(dropout=0.0)
    opt = JTR.make_optimizer(1e-3)
    jp = JM.shard_translator_params(params, jmesh)
    state = JTR.TrainState(jp, opt.init(jp), jnp.int32(0))
    data = JM.batch_sharding(jmesh)
    state, metrics = JTR.make_train_step(opt, jcfg, jmesh)(
        state, jax.device_put(jnp.asarray(x), data),
        jax.device_put(jnp.asarray(y), data), jax.random.PRNGKey(1))
    want = jax.tree.map(np.asarray, state.params)
    plain = TR.init_state(cfg0, 1e-3, params, device="cpu")
    TR.make_train_step(plain)(xt, yt)
    grads = {n: p.grad.numpy() for n, p in plain.head.named_parameters()}
    port = TR.init_state(cfg0, 1e-3, params, device="cpu")
    m = TR.make_train_step(port, tmesh)(xt, yt)
    np.testing.assert_allclose(float(m["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    _params_close(port.head.to_params(), want, grads, 0, 1e-6)


def test_fit_on_mesh_resumes_and_matches_one_device(tmp_path, tmesh):
    """fit on a (4, 2) mesh equals fit on one device; a checkpoint written
    on the mesh resumes there with its moments placed as the weights."""
    x, y = windows(2, 32)
    params = T.init_params(TranslatorConfig(), 3)
    kw = dict(batch_size=16, lr=1e-3, seed=3, verbose=False, params=params)
    want = TR.fit(x, y, epochs=2, device="cpu", **kw)
    got = TR.fit(x, y, epochs=2, mesh=tmesh, **kw)
    ck = str(tmp_path / "ck")
    TR.fit(x, y, epochs=1, mesh=tmesh, checkpoint_dir=ck, **kw)
    resumed = TR.fit(x, y, epochs=2, mesh=tmesh, checkpoint_dir=ck, **kw)
    for name in want:
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k],
                                       rtol=1e-4, atol=5e-5,
                                       err_msg=f"{name}/{k}")
            np.testing.assert_array_equal(resumed[name][k], got[name][k],
                                          err_msg=f"{name}/{k}")


def test_batched_cpm_forward(tmesh):
    params = jax.tree.map(np.asarray, JC.init_params(
        "hand", jax.random.PRNGKey(3)))
    x = np.random.RandomState(0).rand(8, 32, 32, 3).astype(np.float32)
    want = np.asarray(JS.make_batched_forward("hand", None, jnp.float32)(
        params, jnp.asarray(x)))
    state = W.from_islx_params(params)
    got = S.make_batched_forward("hand", tmesh, torch.float32)(
        M.shard_cpm_params(state, tmesh), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("width", [64, 44])
def test_spatial_forward_matches_single(tmesh, width):
    """Width over model (2 stripes), batch over data. W=64: the /8 grid
    splits evenly; W=44: 8 * n_model does not divide it, the last stripe
    holds the ragged end."""
    params = jax.tree.map(np.asarray, JC.init_params(
        "body25", jax.random.PRNGKey(4)))
    x = np.random.RandomState(1).rand(4, 32, width, 3).astype(np.float32)
    want = JS.make_batched_forward("body25", None, jnp.float32)(
        params, jnp.asarray(x))
    state = W.from_islx_params(params)
    got = S.make_spatial_forward("body25", tmesh, torch.float32)(
        state, torch.from_numpy(x))
    single = S.make_batched_forward("body25", None, torch.float32)(
        state, torch.from_numpy(x))
    for name, w, g, s in zip(("paf", "heat"), want, got, single):
        assert g.shape == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), s.numpy(), atol=1e-4,
                                   err_msg=name)


def islx_nets(body, hand):
    """islx's jitted f32 forwards as the port's net callables (so that
    the port's step and islx's see the same maps)."""
    fb = jax.jit(lambda p, x: JC.body25_forward(p, x, jnp.float32))
    fh = jax.jit(lambda p, x, s: JC.hand_forward(p, x, jnp.float32, s),
                 static_argnums=2)

    def body_net(x, cd=torch.float32):
        return tuple(torch.from_numpy(np.array(m))
                     for m in fb(body, jnp.asarray(x.numpy())))

    def hand_net(x, cd, stages=6):
        return torch.from_numpy(np.array(fh(hand, jnp.asarray(x.numpy()),
                                            stages)))

    return body_net, hand_net


def test_fused_step_on_mesh(monkeypatch, jmesh, tmesh):
    """B=8 48x48 frames, 92 px crops, ``bits`` packing: the port's
    sharded step against islx's sharded step (the port running islx's CPM
    forwards, as tests/test_torch_slice.py does) and against the port's
    unsharded step (its own CPMs)."""
    monkeypatch.setenv("ISLX_PACK_MODE", "bits")
    rng = np.random.RandomState(0)
    b, hb, wb = 8, 48, 48
    frames = (rng.rand(b, hb, wb, 3) * 255).astype(np.uint8)
    body = jax.tree.map(np.asarray, JC.init_params("body25"))
    hand = jax.tree.map(np.asarray, JC.init_params("hand"))
    jkw = dict(model_type="body25",
               pose_cfg=JPose(model_type="body25", max_peaks=8),
               hand_cfg=JHand(scale_search=(0.25,)),
               compute_dtype=jnp.float32)
    want = np.asarray(JBP.FusedPosePipeline(body, hand, mesh=jmesh, **jkw)
                      .device_step(frames, thre1=0.05))
    kw = dict(model_type="body25",
              pose_cfg=PoseConfig(model_type="body25", max_peaks=8),
              hand_cfg=HandConfig(scale_search=(0.25,)),
              compute_dtype=torch.float32)
    bp, hp = W.from_islx_params(body), W.from_islx_params(hand)
    single = TBP.FusedPosePipeline(bp, hp, device="cpu", **kw)
    sharded = TBP.FusedPosePipeline(bp, hp, mesh=tmesh, **kw)
    assert sharded.device == torch.device("cpu")
    own = sharded.device_step(frames, thre1=0.05).numpy()
    plain = single.device_step(frames, thre1=0.05).numpy()
    np.testing.assert_array_equal(own, plain)
    body_net, hand_net = islx_nets(body, hand)
    sharded.body.nets[:] = [body_net] * 4
    sharded.hand.nets[:] = [hand_net] * 4
    flat = sharded.upload_frames(frames)
    assert len(flat) == 4
    got = sharded.device_step_flat(flat, b, hb, wb, (hb, wb), 0.05).numpy()
    body_w, boxes_w, peaks_w = single.unpack(want, b)
    body_g, boxes_g, peaks_g = sharded.unpack(got, b)
    np.testing.assert_array_equal(boxes_g, boxes_w)
    np.testing.assert_array_equal(peaks_g, peaks_w)
    assert (boxes_g[:, 3] > 0).any()
    for name, w, g in zip(("xy", "score", "count", "pair", "cscore", "cok"),
                          single.body.unpack(body_w, b),
                          sharded.body.unpack(body_g, b)):
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_served_batch_resized_then_sharded_as_uploaded(tmesh, monkeypatch):
    """The batcher on a meshed pipeline, frames off their bucket's size:
    the batch is uploaded once, resized on the mesh's first device
    (resize_u8), and its shards reach their devices as ``upload_frames``
    places host frames that were resized there: equal shards, on the same
    devices, and the served results equal a direct step's."""
    from islx_torch.ops.resize_u8 import resize_frames
    from islx_torch.serve import MicroBatcher

    kw = dict(model_type="body25",
              pose_cfg=PoseConfig(model_type="body25", max_peaks=8,
                                  thre1=0.05),
              hand_cfg=HandConfig(scale_search=(0.25,)),
              compute_dtype=torch.float32)
    sharded = TBP.FusedPosePipeline(W.init_params("body25"),
                                    W.init_params("hand"), mesh=tmesh, **kw)
    rng = np.random.RandomState(4)
    frames = [(rng.rand(60, 80, 3) * 255).astype(np.uint8) for _ in range(8)]
    hb, wb = TBP.bucket_for(60, 80, target_h=48)
    shards = []
    real = TBP.FusedPosePipeline.device_step_flat

    def recording(self, flat, b, hb, wb, *a, **k):
        shards.append(M.batch_sharding(self.mesh).put_flat(flat, b))
        return real(self, flat, b, hb, wb, *a, **k)

    monkeypatch.setattr(TBP.FusedPosePipeline, "device_step_flat", recording)
    b = MicroBatcher(sharded, max_batch=8, max_wait_ms=2000.0, target_h=48)
    try:
        got = [f.result(timeout=600) for f in [b.submit(f) for f in frames]]
    finally:
        b.close()
    monkeypatch.setattr(TBP.FusedPosePipeline, "device_step_flat", real)
    assert b.stats()["batches"] == 1 and len(shards) == 1
    resized = resize_frames(frames, hb, wb, "cpu")
    want = sharded.upload_frames(resized)
    assert len(shards[0]) == len(want) == 4
    for g, w in zip(shards[0], want):
        assert g.device == w.device
        assert torch.equal(g, w)
    results = sharded.assemble(sharded.device_step(resized, (60, 80)), 8)
    for r, (cand, subset) in zip(got, results[0]):
        cand = cand.copy()
        cand[:, 0] *= 80 / wb
        cand[:, 1] *= 60 / hb
        np.testing.assert_array_equal(r.candidate, cand)
        np.testing.assert_array_equal(r.subset, subset)


def test_cross_shard_crop_gather_exact(tmesh):
    """Every crop names a frame another shard holds (frame index
    reversed): each shard gathers those frames, and its crops equal the
    unsharded ones word for word."""
    rng = np.random.RandomState(7)
    b, hb, wb, size = 8, 48, 64, 32
    frames = torch.from_numpy((rng.rand(b, hb, wb, 3) * 255).astype(
        np.uint8))
    fidx = np.arange(b - 1, -1, -1, dtype=np.int32)
    x0 = rng.randint(0, wb - 20, b).astype(np.int32)
    y0 = rng.randint(0, hb - 20, b).astype(np.int32)
    w = rng.randint(8, 20, b).astype(np.int32)

    def crop(fr, f, sl):
        return dynamic_crop_resize_batch(
            fr.float(), torch.from_numpy(f), torch.from_numpy(x0[sl]),
            torch.from_numpy(y0[sl]), torch.from_numpy(w[sl]), size)

    want = crop(frames, fidx, slice(None))
    shards = M.batch_sharding(tmesh).put(frames)
    got = []
    for i, dev in enumerate(tmesh.data_devices):
        sl = slice(2 * i, 2 * i + 2)
        mine, idx = M.gather_rows(shards, fidx[sl], dev)
        assert len(mine) == 2 and not set(fidx[sl]) & {2 * i, 2 * i + 1}
        got.append(crop(mine, idx, sl))
    assert torch.equal(torch.cat(got), want)


def test_hand_core_cross_shard_boxes(tmesh):
    """The hand core under data sharding with boxes naming other shards'
    frames: the same peaks as the unsharded pipeline, and islx's core."""
    rng = np.random.RandomState(8)
    b, hb, wb = 8, 48, 48
    frames = (rng.rand(b, hb, wb, 3) * 255).astype(np.uint8)
    hand = jax.tree.map(np.asarray, JC.init_params("hand"))
    n = b * 2
    boxes = np.zeros((n, 4), np.int32)
    boxes[:, 0] = (np.arange(n) // 2 + 3) % b
    boxes[:, 1] = rng.randint(0, wb - 16, n)
    boxes[:, 2] = rng.randint(0, hb - 16, n)
    boxes[:, 3] = rng.randint(8, 16, n)
    boxes[1::4, 3] = 0
    jpipe = JBP.BatchedHandPipeline(hand, JHand(scale_search=(0.25,)),
                                    compute_dtype=jnp.float32)
    jxy, jvalid = jax.jit(jpipe._crops_core_fn())(
        jpipe.params, jnp.asarray(frames), jnp.asarray(boxes))
    want = np.where(np.asarray(jvalid)[:, :, None],
                    np.rint(np.asarray(jxy)).astype(np.int32), 0)
    state = W.from_islx_params(hand)
    cfg = HandConfig(scale_search=(0.25,))
    single = TBP.BatchedHandPipeline(state, cfg, compute_dtype=torch.float32,
                                     device="cpu")
    sharded = TBP.BatchedHandPipeline(state, cfg, mesh=tmesh,
                                      compute_dtype=torch.float32)
    flat = torch.from_numpy(frames.reshape(-1))
    got = sharded.from_frames(flat, b, hb, wb, boxes)
    np.testing.assert_array_equal(got, single.from_frames(flat, b, hb, wb,
                                                          boxes))
    sharded.nets[:] = [islx_nets(None, hand)[1]] * 4
    np.testing.assert_array_equal(
        sharded.from_frames(flat, b, hb, wb, boxes), want)
    assert (want != 0).any()


@pytest.mark.parametrize("model_type", ["body25", "coco", "hand"])
def test_pipelined_forward_matches_single(model_type):
    """Three segments; their weights partition the net's and live on
    their own device; the outputs are islx's single forward's."""
    params = jax.tree.map(np.asarray, JC.init_params(
        model_type, jax.random.PRNGKey(5)))
    state = W.from_islx_params(params)
    pipe = PipelinedCPM(state, model_type, CPU8[:3], torch.float32)
    seen = []
    for seg in pipe.segments:
        for name, layer in seg["net"].layers.items():
            assert all(p.device == seg["device"]
                       for p in layer.parameters()), name
        seen += list(seg["net"].layers)
    assert sorted(seen) == sorted(params)
    x = np.random.RandomState(2).rand(4, 24, 32, 3).astype(np.float32)
    want = jax.jit(lambda p, x: JC.FORWARDS[model_type](p, x, jnp.float32))(
        params, jnp.asarray(x))
    got = pipe.forward(torch.from_numpy(x), n_micro=2)
    for w, g in zip(_outs(want), _outs(got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_pipelined_grads_match_full_batch():
    """GPipe accumulation (a backward a microbatch, averaged) equals the
    full-batch gradient of the same MSE objective."""
    rng = np.random.RandomState(0)
    state = W.init_params("hand", 6)
    pipe = PipelinedCPM(state, "hand", CPU8[:2], torch.float32)
    x = torch.from_numpy(rng.rand(4, 16, 16, 3).astype(np.float32))
    t = torch.from_numpy(rng.rand(4, 2, 2, 22).astype(np.float32))
    loss, seg_grads = pipe.grads(x, t, n_micro=2)
    net = cpm.CPM("hand").load_params(state).trainable()
    want = torch.mean((net(x, torch.float32) - t) ** 2)
    want.backward()
    np.testing.assert_allclose(float(loss), float(want.detach()), rtol=1e-5)
    got = {n: g for seg in seg_grads for n, g in seg.items()}
    assert sorted(got) == sorted(net.layers)
    for name, layer in net.layers.items():
        for k, p in (("w", layer.weight), ("b", layer.bias)):
            np.testing.assert_allclose(got[name][k].numpy(), p.grad.numpy(),
                                       atol=1e-5, rtol=1e-4,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("model_type,deep,pos", [("hand", True, 2.0),
                                                 ("body25", False, 0.0)])
def test_pose_train_step_on_mesh(tmesh, model_type, deep, pos):
    """One f32 step on the (4, 2) mesh against the unsharded step: the
    loss over the global batch (deep supervision and pos_weight as they
    are), the gradients summed over the shards."""
    rng = np.random.RandomState(3)
    state0 = W.init_params(model_type, 2)
    x = torch.from_numpy(rng.rand(4, 16, 16, 3).astype(np.float32) - 0.5)
    c = 22 if model_type == "hand" else 26
    heat = torch.from_numpy(rng.rand(4, 2, 2, c).astype(np.float32))
    paf = torch.from_numpy(rng.rand(4, 2, 2, 52 if model_type == "body25"
                                    else 0).astype(np.float32))
    metrics = []
    states = []
    for mesh in (None, tmesh):
        st = PT.init_state(model_type, 1e-4, state0, device="cpu")
        step = PT.make_train_step(st, model_type, torch.float32, pos, deep,
                                  mesh=mesh)
        metrics.append(step(x, heat, paf))
        states.append(st)
    np.testing.assert_allclose(float(metrics[1]["loss"]),
                               float(metrics[0]["loss"]), rtol=1e-5)
    # every data row ran its own copy, reduced into the master
    replicas = PT.MeshNet(cpm.CPM(model_type).load_params(state0), tmesh)
    assert len({id(r) for r in replicas.replicas}) == 4
    named = [dict(st.net.named_parameters()) for st in states]
    for n, p in named[0].items():
        q = named[1][n]
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(
            states[1].optimizer.state[q]["exp_avg"].numpy(),
            states[0].optimizer.state[p]["exp_avg"].numpy(),
            rtol=1e-4, atol=1e-8, err_msg=n)
    grads = {n: p.grad.numpy() for n, p in states[0].net.named_parameters()}
    got, want = states[1].net.state(), states[0].net.state()
    for name in want:
        for k, key in (("w", "weight"), ("b", "bias")):
            flip = np.abs(grads[f"layers.{name}.{key}"]) <= 1e-6
            err = (got[name][k] - want[name][k]).abs().numpy()
            assert (err <= 1e-6 + 2e-4 * flip).all(), (name, k, err.max())
