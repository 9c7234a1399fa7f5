"""``.keras`` files written by the port without keras
(islx_torch.models.keras_export, one_model, translator's head writer)
against stock keras and islx's importers, and islx's files read by the
port, on the CPU (islx's tests/test_keras_export.py and
tests/test_one_model.py, for the port).

Tolerances: parameters are equal word for word whichever side writes and
reads; a keras forward of the port's file matches the port's f32 CPM
within rtol/atol 1e-4 (the convolutions sum in another order); the
imported head's forward matches islx's within atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

keras = pytest.importorskip("keras")
pytest.importorskip("h5py")

from islx.core.config import TranslatorConfig as JTrCfg  # noqa: E402
from islx.models import cpm as JC  # noqa: E402
from islx.models import keras_export as JKE  # noqa: E402
from islx.models import one_model as JOM  # noqa: E402
from islx.models import translator as JT  # noqa: E402
from islx_torch.cli import convert as TCV  # noqa: E402
from islx_torch.core import weights as W  # noqa: E402
from islx_torch.models import keras_export as KE  # noqa: E402
from islx_torch.models import one_model as OM  # noqa: E402
from islx_torch.models import translator as T  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _islx(model_type, seed):
    return jax.tree.map(np.asarray, JC.init_params(
        model_type, jax.random.PRNGKey(seed)))


def _same_state(got, want):
    assert set(got) == set(want)
    for n in want:
        assert got[n].keys() == want[n].keys(), n
        for k in want[n]:
            assert torch.equal(got[n][k], want[n][k]), (n, k)


def _same_islx(got, want):
    assert set(got) == set(want)
    for n in want:
        assert set(got[n]) == set(want[n]), n
        for k in want[n]:
            np.testing.assert_array_equal(np.asarray(got[n][k]),
                                          np.asarray(want[n][k]),
                                          err_msg=f"{n}/{k}")


def _same_head(got, want):
    assert set(got) == set(want)
    for n in want:
        for k in want[n]:
            np.testing.assert_array_equal(np.asarray(got[n][k]),
                                          np.asarray(want[n][k]),
                                          err_msg=f"{n}/{k}")


@pytest.mark.parametrize("model_type,hw,seed", [
    ("body25", 24, 0), ("coco", 24, 1), ("hand", 40, 2)])
def test_cpm_export_loads_in_keras_and_islx(tmp_path, model_type, hw, seed):
    """The port's file: stock keras loads it, islx's ``params_from_keras``
    gives the source params back, its keras forward matches the port's
    CPM; islx's file gives the same params in the port's reader."""
    params = _islx(model_type, seed)
    state = W.from_islx_params(params)
    path = str(tmp_path / f"{model_type}.keras")
    KE.export_keras(state, model_type, path)
    model = keras.models.load_model(path, compile=False)
    assert model.name == f"islx_{model_type}"
    assert model.count_params() == JC.param_count(model_type)
    _same_islx(JKE.params_from_keras(model, model_type), params)
    _same_state(KE.params_from_keras(path, model_type), state)

    x = np.random.RandomState(seed).rand(1, hw, hw, 3).astype(np.float32)
    outs = model.predict(x, verbose=0)
    outs = outs if isinstance(outs, list) else [outs]
    net = W.build(model_type, state, "cpu", torch.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(x))
    want = list(want) if isinstance(want, tuple) else [want]
    assert len(outs) == len(want)
    for k_out, t_out in zip(outs, want):
        np.testing.assert_allclose(np.asarray(k_out), t_out.numpy(),
                                   rtol=1e-4, atol=1e-4)

    theirs = str(tmp_path / f"islx_{model_type}.keras")
    JKE.export_keras(params, model_type, theirs)
    _same_state(KE.params_from_keras(theirs, model_type), state)


def test_legacy_h5_and_refusals(tmp_path):
    """islx's legacy .h5 export reads into the same params; the port
    writes .keras only."""
    params = _islx("hand", 3)
    path = str(tmp_path / "hand.h5")
    JKE.export_keras(params, "hand", path)
    _same_state(KE.params_from_keras(path, "hand"), W.from_islx_params(params))
    with pytest.raises(ValueError, match=".keras"):
        KE.export_keras(W.from_islx_params(params), "hand", path)


def test_config_is_islx_graph():
    """The config's layers, in keras's order, are islx's graph: the same
    classes and names as a model islx's ``build_keras_model`` builds (pool
    and concatenate names are keras's automatic ones)."""
    for model_type in ("body25", "coco", "hand"):
        g, inp, outs = KE.cpm_graph(model_type)
        got = g.model_config([inp], outs, True)
        model = JKE.build_keras_model(model_type)
        want = model.get_config()
        auto = ("max_pooling2d", "concatenate")
        names = [la.name if not la.name.startswith(auto)
                 else la.name.split("_")[0] for la in model.layers]
        assert [la["name"] if not la["name"].startswith(auto)
                else la["name"].split("_")[0] for la in got["layers"]] \
            == names
        assert [la["class_name"] for la in got["layers"]] == \
            [la["class_name"] for la in want["layers"]]
        assert len(got["output_layers"]) == len(want["output_layers"])


def test_convert_to_keras(tmp_path, capsys):
    """``convert --to-keras`` writes a .keras of the source weights."""
    from test_torch_caffe import seeded_state, write_state

    state = seeded_state("hand", 7)
    src = str(tmp_path / "hand.caffemodel")
    write_state(src, state)
    dst = str(tmp_path / "hand.keras")
    TCV.main([src, dst, "--model-type", "hand", "--to-keras"])
    assert "params, verified" in capsys.readouterr().out
    _same_state(KE.params_from_keras(dst, "hand"), state)
    model = keras.models.load_model(dst, compile=False)
    _same_state(W.from_islx_params(jax.tree.map(
        np.asarray, JKE.params_from_keras(model, "hand"))), state)


def test_head_export_loads_everywhere(tmp_path, rng):
    """The head writer: the port's and islx's ``load_keras`` and stock
    keras read the head; keras's forward is islx's."""
    cfg = JTrCfg()
    head = jax.tree.map(np.asarray, JT.init_params(
        cfg, key=jax.random.PRNGKey(4)))
    path = str(tmp_path / "head.keras")
    T.export_keras_head(head, path)
    _same_head(T.load_keras(path), head)
    _same_head(JT.load_keras(path), head)
    model = keras.models.load_model(path, compile=False)
    x = rng.randn(2, cfg.window_size, cfg.feature_dim).astype(np.float32)
    np.testing.assert_allclose(model.predict(x, verbose=0),
                               np.asarray(JT.forward(head, jnp.asarray(x))),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the one-model artifact


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = JTrCfg()
    body, hand = _islx("body25", 0), _islx("hand", 1)
    head = jax.tree.map(np.asarray, JT.init_params(
        cfg, key=jax.random.PRNGKey(2)))
    path = str(tmp_path_factory.mktemp("one") / "islx-translate-v1.keras")
    OM.export_one_model(W.from_islx_params(body), W.from_islx_params(hand),
                        head, path, cfg=cfg)
    return path, cfg, body, hand, head


def test_roundtrip_params(artifact):
    """The port's artifact: the port's importer and islx's give the
    source params back."""
    path, cfg, body, hand, head = artifact
    b, h, hd = OM.import_one_model(path)
    _same_state(b, W.from_islx_params(body))
    _same_state(h, W.from_islx_params(hand))
    _same_head(hd, head)
    jb, jh, jhd = JOM.import_one_model(path)
    _same_islx(jb, body)
    _same_islx(jh, hand)
    _same_head(jhd, head)
    assert OM.model_type_of(path) == "body25"


def test_imported_head_forward_matches(artifact, rng):
    path, cfg, _, _, head = artifact
    _, _, head2 = OM.import_one_model(path)
    x = rng.randn(2, cfg.window_size, cfg.feature_dim).astype(np.float32)
    with torch.no_grad():
        got = T.build_head(head2, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JT.forward(head, x)),
                               atol=1e-5)


def test_artifact_loads_in_stock_keras(artifact, rng):
    path, cfg, _, _, _ = artifact
    model = keras.models.load_model(path, compile=False)
    img = rng.rand(1, 64, 64, 3).astype(np.float32)
    crop = rng.rand(1, 32, 32, 3).astype(np.float32)
    win = rng.randn(1, cfg.window_size, cfg.feature_dim).astype(np.float32)
    outs = model.predict([img, crop, win], verbose=0)
    assert outs[0].shape[-1] == 52          # body25 PAF
    assert outs[1].shape[-1] == 26          # body25 heatmap
    assert outs[2].shape[-1] == 22          # hand heatmap
    assert outs[3].shape == (1, cfg.n_classes)
    np.testing.assert_allclose(outs[3].sum(), 1.0, rtol=1e-4)


@pytest.mark.parametrize("ext", ["keras", "h5"])
def test_islx_artifact_imports(tmp_path, ext):
    """islx's one-model artifacts (COCO, .keras and legacy .h5) load in
    the port's importer equal to their source params."""
    cfg = JTrCfg()
    body, hand = _islx("coco", 5), _islx("hand", 6)
    head = jax.tree.map(np.asarray, JT.init_params(
        cfg, key=jax.random.PRNGKey(7)))
    path = str(tmp_path / f"one.{ext}")
    JOM.export_one_model(body, hand, head, path, model_type="coco", cfg=cfg)
    assert OM.model_type_of(path) == "coco"
    b, h, hd = OM.import_one_model(path, "coco")
    _same_state(b, W.from_islx_params(body))
    _same_state(h, W.from_islx_params(hand))
    _same_head(hd, head)


def test_import_rejects_foreign_artifact(tmp_path):
    m = keras.Sequential([keras.layers.Dense(3)])
    m.build((None, 4))
    for ext in ("keras", "h5"):
        path = str(tmp_path / f"foreign.{ext}")
        m.save(path)
        with pytest.raises(ValueError, match="one-model"):
            OM.import_one_model(path)
    with pytest.raises(ValueError, match=".keras"):
        OM.export_one_model({}, {}, {}, str(tmp_path / "x.h5"))


@pytest.fixture
def rng():
    return np.random.RandomState(0)
