"""The port's training-UI pieces (ui/png.py, ui/components.py,
ui/convolutional.py) against the JAX package's, on the CPU.

PNG bytes, activation mosaics, component JSON and ``render_html`` are
equal between the two packages (the first two are copies over numpy and
zlib, the last two over the standard library). ``ConvolutionalListener``
runs over each package's ``feed_forward`` of the committed digits LeNet:
its PNGs decode to the JAX listener's grids within one gray level (the
mosaics are min-max scaled floats truncated to 8 bits, so a last-bit
difference in an activation can move a pixel by one level), and it fires
through ``fit`` and lands in a stats storage.
"""

import base64
import json
import struct
import zlib

import numpy as np
import pytest

from deeplearning4j_tpu_torch.ui import components as tc
from deeplearning4j_tpu_torch.ui import png as tpng


def _jpng():
    from deeplearning4j_tpu.ui import png
    return png


def _jcomp():
    from deeplearning4j_tpu.ui import components
    return components


def decode_png_gray(data: bytes) -> np.ndarray:
    """The (H, W) uint8 image of an 8-bit grayscale PNG with filter 0
    rows (what ``encode_png_gray`` writes)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, (w, h) = 8, b"", (None, None)
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert not raw[:, 0].any()
    return raw[:, 1:]


IMAGES = {
    "float_ramp": np.linspace(-3, 5, 35).reshape(5, 7),
    "uint8": (np.arange(48) * 5 % 256).astype(np.uint8).reshape(6, 8),
    "constant": np.full((3, 4), 2.5),
    "random": np.random.default_rng(0).normal(size=(17, 9)),
}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_png_bytes_match_jax(name):
    img = IMAGES[name]
    got = tpng.encode_png_gray(img)
    assert got == _jpng().encode_png_gray(img)
    back = decode_png_gray(got)
    assert back.shape == img.shape
    if img.dtype == np.uint8:
        np.testing.assert_array_equal(back, img)


ACTS = {
    "hwc": np.random.default_rng(1).normal(size=(6, 5, 7)),
    "many_channels": np.random.default_rng(2).normal(size=(3, 3, 80)),
    "hw": np.random.default_rng(3).normal(size=(4, 9)),
    "dense": np.random.default_rng(4).normal(size=(12,)),
}


@pytest.mark.parametrize("name", sorted(ACTS))
def test_activation_grid_matches_jax(name):
    a = ACTS[name]
    got = tpng.activation_grid(a, max_channels=64)
    np.testing.assert_array_equal(got, _jpng().activation_grid(a, 64))
    assert got.min() >= 0 and got.max() <= 1
    with pytest.raises(ValueError):
        tpng.encode_png_gray(np.zeros((2, 2, 2)))


def _components(mod):
    style = mod.StyleChart(width=320, height=200)
    line = mod.ChartLine(title="loss <score>", style=style)
    line.add_series("train", [0, 1, 2, 3], [2.3, 1.1, 0.7, 0.5])
    line.add_series("test & held", [0, 2], [2.4, 0.9])
    scatter = mod.ChartScatter(title="tsne")
    scatter.add_series("pts", [0.5, -1.0, 3.0], [1.0, 2.0, -0.5])
    hist = mod.ChartHistogram(title="weights")
    for lo, hi, n in ((-1, -0.5, 3), (-0.5, 0, 10), (0, 0.5, 7.5)):
        hist.add_bin(lo, hi, n)
    table = mod.ComponentTable(header=["layer", "params"],
                               rows=[["conv", "500"], ["<dense>", "10"]],
                               title="summary")
    text = mod.ComponentText(text="a \"quoted\" & <escaped> note")
    div = mod.ComponentDiv().add(text).add(mod.ComponentText(text="two"))
    return [line, scatter, hist, table, text, div]


@pytest.mark.parametrize("i", range(6), ids=["line", "scatter", "histogram",
                                            "table", "text", "div"])
def test_component_json_matches_jax(i):
    got, want = _components(tc)[i], _components(_jcomp())[i]
    assert got.to_json() == want.to_json()
    assert json.loads(got.to_json())["componentType"] == \
        type(got).component_type


def test_render_html_matches_jax():
    got = tc.render_html(_components(tc), title="report")
    assert got == _jcomp().render_html(_components(_jcomp()), title="report")
    assert got.startswith("<!DOCTYPE html>") and "<svg" in got
    assert "&lt;dense&gt;" in got
    assert tc.render_html(_components(tc), title="") == \
        _jcomp().render_html(_components(_jcomp()), title="")
    with pytest.raises(ValueError):
        tc.ChartLine().add_series("bad", [1, 2], [1])
    with pytest.raises(NotImplementedError):
        tc.Component().to_dict()


class _Capture:
    def __init__(self):
        self.updates = []

    def put_update(self, update):
        self.updates.append(update)


@pytest.fixture(scope="module")
def lenets():
    from deeplearning4j_tpu.zoo.models import LeNet as JLeNet
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    return (LeNet().init_pretrained(flavor="digits", device="cpu"),
            JLeNet().init_pretrained(flavor="digits"))


def _digit():
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    return next(iter(DigitsDataSetIterator(8, train=False,
                                           shuffle=False))).features


def test_convolutional_listener_matches_jax(lenets):
    from deeplearning4j_tpu.ui.convolutional import \
        ConvolutionalListener as JListener
    from deeplearning4j_tpu_torch.ui.convolutional import \
        ConvolutionalListener
    tm, jm = lenets
    x = _digit()
    got, want = _Capture(), _Capture()
    for listener, model in ((ConvolutionalListener(got, "s", frequency=5),
                             tm),
                            (JListener(want, "s", frequency=5), jm)):
        listener.iteration_done(model, 3, 0, 0.0, 0.0, 8)   # not due
        listener.iteration_done(model, 5, 0, 0.0, 0.0, 8)   # no example
        listener.set_example(x)
        listener.iteration_done(model, 10, 0, 0.0, 0.0, 8)
    assert len(got.updates) == len(want.updates) == 1
    g, w = got.updates[0], want.updates[0]
    assert (g["type"], g["iteration"], g["session_id"]) == (
        w["type"], w["iteration"], w["session_id"]) == ("activations", 10,
                                                        "s")
    assert list(g["activations_png"]) == list(w["activations_png"])
    assert len(g["activations_png"]) >= 4
    for name, b64 in g["activations_png"].items():
        a = decode_png_gray(base64.b64decode(b64)).astype(int)
        b = decode_png_gray(base64.b64decode(
            w["activations_png"][name])).astype(int)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1, name


def test_convolutional_listener_fires_through_fit(lenets):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.ui.convolutional import \
        ConvolutionalListener
    from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
    tm, _ = lenets
    model = tm.clone()
    storage = InMemoryStatsStorage()
    x = _digit()
    y = np.eye(10, dtype=np.float32)[np.arange(len(x)) % 10]
    listener = ConvolutionalListener(storage, frequency=2).set_example(x)
    model.set_listeners(listener)
    start = model.iteration
    for _ in range(4):
        model.fit(DataSet(x, y))
    ups = [u for u in storage.get_all_updates(listener.session_id)
           if u.get("type") == "activations"]
    assert [u["iteration"] for u in ups] == [
        i for i in range(start + 1, start + 5) if i % 2 == 0]
    assert len(ups) == 2
