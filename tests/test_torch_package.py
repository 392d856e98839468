"""Package rules of the PyTorch/CUDA port: it imports neither JAX nor the
JAX package, its entry points refuse to run silently on the CPU, its
kernel wrappers never fall back, and its configurations, enums and
initializers match the JAX package's by name."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.ops import fused_conv as fc
from deeplearning4j_tpu_torch.utils import device as device_mod

REPO = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax():
    code = ("import sys, pkgutil, importlib\n"
            "import deeplearning4j_tpu_torch as p, chip_smoke\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ("
            "'jax', 'optax', 'sklearn', 'deeplearning4j_tpu')]\n"
            "print(bad)\n"
            "need = {'deeplearning4j_tpu_torch.' + m for m in ("
            "'optimize.solver', 'datasets.dataset', 'models.base', "
            "'ops.losses', 'ops.fused_conv', 'ops.fused_lstm', "
            "'nn.layers.recurrent', 'models.multi_layer_network', "
            "'generation.decode', 'ops.flash_attention', "
            "'nn.layers.attention', 'datasets.feeder', "
            "'datasets.fetchers', 'datasets.iterators', "
            "'evaluation.evaluation', 'evaluation.curves', "
            "'evaluation.results', 'nn.dropout', 'optimize.schedules')}\n"
            "assert need <= set(sys.modules), need - set(sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                              "HOME": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.models.serialization import (restore_model,
                                                               save_model)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    rn = ResNet50(num_classes=3, height=16, width=16, fused_blocks=True)
    path = str(tmp_path / "m.zip")
    save_model(rn.init(device="cpu"), path)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        ComputationGraph(rn.conf())
    with pytest.raises(RuntimeError, match="CUDA"):
        rn.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_model(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_model(path, load_updater=True)
    assert restore_model(path, device="cpu").device.type == "cpu"
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_lstm_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serialization import (
        restore_model, restore_multi_layer_network, save_model)
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    tg = TextGenerationLSTM(vocab_size=5, timesteps=4, lstm_units=3)
    path = str(tmp_path / "lstm.zip")
    save_model(tg.init(device="cpu"), path, save_updater=True)
    _no_cuda(monkeypatch)
    for make in (lambda: MultiLayerNetwork(tg.conf()), tg.init,
                 TextGenerationLSTM().init_pretrained,
                 lambda: restore_model(path),
                 lambda: restore_multi_layer_network(path,
                                                     load_updater=True)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert restore_multi_layer_network(path, device="cpu").device.type == \
        "cpu"
    assert TextGenerationLSTM().init_pretrained(device="cpu").device.type \
        == "cpu"


def test_digit_models_and_the_feeder_default_to_cuda_and_raise_without_it(
        monkeypatch):
    """LeNet and SimpleCNN, built or restored, raise without a card unless
    the CPU is asked for; the feeder's card transport needs a card too
    (no unstaged fallback)."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    from deeplearning4j_tpu_torch.datasets.feeder import DeviceFeeder
    from deeplearning4j_tpu_torch.zoo.models import LeNet, SimpleCNN
    _no_cuda(monkeypatch)
    for make in (LeNet().init, SimpleCNN().init,
                 lambda: LeNet().init_pretrained(flavor="digits"),
                 lambda: SimpleCNN().init_pretrained(flavor="digits")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert LeNet().init(device="cpu").device.type == "cpu"
    data = DataSet(np.zeros((4, 2), np.float32), np.zeros((4, 2),
                                                          np.float32))
    assert DeviceFeeder(ArrayDataSetIterator(data, 2),
                        device="cpu").transport is None
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceFeeder(ArrayDataSetIterator(data, 2), device=device)


def test_attention_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from deeplearning4j_tpu_torch.models.serialization import \
        restore_multi_layer_network
    path = str(REPO / "tests" / "resources" / "regression" / "attn_v1.zip")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_multi_layer_network(path)
    assert restore_multi_layer_network(path, device="cpu").device.type == \
        "cpu"


def test_textgen_pretrained_checksum_enforced(monkeypatch):
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    monkeypatch.setattr(TextGenerationLSTM, "PRETRAINED", dict(
        TextGenerationLSTM.PRETRAINED, checksum=1234))
    with pytest.raises(IOError, match="Adler32"):
        TextGenerationLSTM().init_pretrained(device="cpu")


def test_wrappers_never_fall_back_off_the_cpu():
    x = torch.empty((1, 2, 2, 4), device="meta")
    w = torch.empty((4, 4), device="meta")
    s = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fc.fused_mm(x, w, s, s)
    with pytest.raises(ValueError, match="unsupported device"):
        fc.fused_c3(x, torch.empty((3, 3, 4, 4), device="meta"), s, s)
    w3 = torch.empty((3, 3, 4, 4), device="meta")
    d = torch.empty((2, 4), device="meta")
    for fn, args in ((fc.fused_mm_bwd, (x, x, x, w, d, s, s)),
                     (fc.fused_c3_bwd, (x, x, x, w3, d, s, s)),
                     (fc.fused_c3_bwd_in, (x, x, x, w3, d, s, s)),
                     (fc.fused_c3_bwd_w, (x, x, x, d, s, s))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*args)
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    zx = torch.empty((3, 2, 16), device="meta")
    hs = torch.empty((2, 4), device="meta")
    seq = torch.empty((3, 2, 4), device="meta")
    wh = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fl.lstm_fwd(zx, hs, hs, wh)
    with pytest.raises(ValueError, match="unsupported device"):
        fl.lstm_bwd(seq, hs, hs, zx, seq, seq, seq, None, wh)
    assert fl.LAUNCHES == {"lstm_fwd": 0, "lstm_bwd": 0}
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    q = torch.empty((2, 5, 3, 8), device="meta")
    rows = torch.empty((2, 3, 5), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_fwd(q, q, q)
    for fn in (fa.flash_bwd_dkv, fa.flash_bwd_dq):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, q, q, None, q, rows, rows)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q)
    assert set(fa.LAUNCHES.values()) == {0}


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="build failed"):
        cuda_build.build(["fused_mm"])
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.kernel("fused_c3")
    assert not list(tmp_path.glob("*.so"))


def test_library_names_follow_the_sources():
    a = cuda_build.library_path("fused_mm")
    assert a.parent == cuda_build.BUILD_DIR and a.suffix == ".so"
    assert a.name.startswith("libfused_mm_")
    assert set(cuda_build.SIGNATURES) == {
        "fused_mm", "fused_c3", "fused_mm_bwd", "fused_c3_bwd",
        "fused_c3_bwd_in", "fused_c3_bwd_w", "lstm_fwd", "lstm_bwd",
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"}
    assert cuda_build.SOURCES == ("fused_mm", "fused_c3", "fused_mm_bwd",
                                  "fused_c3_bwd", "lstm_fwd", "lstm_bwd",
                                  "flash_fwd", "flash_bwd")
    assert cuda_build.SOURCE_OF["fused_c3_bwd_w"] == "fused_c3_bwd"
    assert cuda_build.SOURCE_OF["flash_bwd_dq"] == "flash_bwd"
    for src in cuda_build.SOURCES:
        assert (cuda_build.CSRC / f"{src}.cu").exists()


def test_enum_members_match_jax():
    from deeplearning4j_tpu.nn.layers.convolution import \
        ConvolutionMode as JMode
    from deeplearning4j_tpu.nn.layers.convolution import \
        PoolingType as JPool
    from deeplearning4j_tpu.ops.activations import Activation as JAct
    from deeplearning4j_tpu.ops.initializers import WeightInit as JInit
    from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionMode, PoolingType)
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.ops.initializers import WeightInit
    from deeplearning4j_tpu_torch.ops.losses import LossFunction
    for mine, theirs in ((Activation, JAct), (WeightInit, JInit),
                         (LossFunction, JLoss), (ConvolutionMode, JMode),
                         (PoolingType, JPool)):
        assert {m.name: m.value for m in mine} == \
            {m.name: m.value for m in theirs}


@pytest.mark.parametrize("name", ["Sgd", "Nesterovs", "Adam", "AdamW",
                                  "AdaMax", "Nadam", "AMSGrad", "RmsProp",
                                  "AdaGrad", "AdaDelta", "NoOp",
                                  "GradientNormalizationConfig"])
def test_updater_configs_round_trip_with_jax(name):
    import dataclasses
    from deeplearning4j_tpu.optimize import updaters as jup
    from deeplearning4j_tpu.utils import serde as jserde
    from deeplearning4j_tpu_torch.optimize import updaters as tup
    from deeplearning4j_tpu_torch.utils import serde as tserde
    mine, theirs = getattr(tup, name), getattr(jup, name)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert tserde.to_dict(mine()) == jserde.to_dict(theirs())
    back = jserde.from_json(tserde.to_json(mine()))
    assert type(back) is theirs and back == theirs()


@pytest.mark.parametrize("scheme,std", [
    ("HE_NORMAL", lambda fi, fo: (2.0 / fi) ** 0.5),
    ("XAVIER", lambda fi, fo: (2.0 / (fi + fo)) ** 0.5),
    ("LECUN_NORMAL", lambda fi, fo: (1.0 / fi) ** 0.5),
    ("HE_UNIFORM", lambda fi, fo: (6.0 / fi / 3.0) ** 0.5),
    ("XAVIER_UNIFORM", lambda fi, fo: (6.0 / (fi + fo) / 3.0) ** 0.5)])
def test_initializer_statistics(scheme, std):
    from deeplearning4j_tpu_torch.ops.initializers import WeightInit
    w = getattr(WeightInit, scheme).init(torch.Generator().manual_seed(0),
                                         (256, 512), 256, 512)
    assert w.dtype == torch.float32 and w.shape == (256, 512)
    assert abs(w.mean().item()) < 0.01 * std(256, 512) * 10
    assert w.std().item() == pytest.approx(std(256, 512), rel=0.03)


def test_initializer_is_seeded():
    from deeplearning4j_tpu_torch.ops.initializers import WeightInit
    a = WeightInit.HE_NORMAL.init(torch.Generator().manual_seed(3), (4, 4),
                                  4, 4)
    b = WeightInit.HE_NORMAL.init(torch.Generator().manual_seed(3), (4, 4),
                                  4, 4, dtype=torch.bfloat16)
    assert torch.equal(a.to(torch.bfloat16), b)
    assert torch.equal(WeightInit.IDENTITY.init(None, (3, 3), 3, 3),
                       torch.eye(3))


@pytest.mark.parametrize("act", ["RELU", "RELU6", "LEAKYRELU", "ELU", "SELU",
                                 "GELU", "SIGMOID", "HARDSIGMOID", "TANH",
                                 "HARDTANH", "RATIONALTANH", "RECTIFIEDTANH",
                                 "SOFTMAX", "LOGSOFTMAX", "SOFTPLUS",
                                 "SOFTSIGN", "SWISH", "MISH", "CUBE",
                                 "THRESHOLDEDRELU", "IDENTITY"])
def test_activations_match_jax(act):
    import jax.numpy as jnp
    from deeplearning4j_tpu.ops.activations import Activation as JAct
    from deeplearning4j_tpu_torch.ops.activations import Activation
    x = np.linspace(-4, 4, 33, dtype=np.float32).reshape(3, 11)
    want = np.asarray(getattr(JAct, act).apply(jnp.asarray(x)))
    got = getattr(Activation, act).apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_param_keys_match_jax():
    from deeplearning4j_tpu.nn import param_keys as jpk
    from deeplearning4j_tpu_torch.nn import param_keys as tpk
    assert tpk.BIAS_KEYS == jpk.BIAS_KEYS
    assert tpk.EXCLUDED_KEYS == jpk.EXCLUDED_KEYS
    assert tpk.is_bias_key("beta") and tpk.is_weight_key("W1")
    assert not tpk.is_weight_key("centers")


def test_latency_ring_matches_jax():
    from deeplearning4j_tpu.observe.latency import LatencyRing as JRing
    from deeplearning4j_tpu_torch.observe.latency import LatencyRing
    a, b = LatencyRing(16), JRing(16)
    for v in np.random.default_rng(0).uniform(0, 1, 40):
        a.record(v)
        b.record(v)
    assert a.quantiles() == b.quantiles() and a.count == b.count
    assert a.delta_quantiles() == b.delta_quantiles()


def test_configuration_round_trips_through_json():
    from deeplearning4j_tpu_torch.nn.graph.config import \
        ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    conf = ResNet50(height=32, width=32, fused_blocks=True,
                    s2d_stem=True).conf()
    back = ComputationGraphConfiguration.from_json(conf.to_json())
    assert json.loads(back.to_json()) == json.loads(conf.to_json())
    assert back.topological_order() == conf.topological_order()
