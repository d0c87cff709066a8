"""The port's int8 quantized convs (``models/quant.py``) against JAX's.

Op level, the port's conv equals JAX's jitted ``QuantConv`` (dynamic and
static) up to f32 summation order.  The JAX engine runs its models jitted,
and XLA compiles ``amax / 127.0`` as ``amax * f32(1/127)``; the port does
the same, so against eager JAX (which divides) a few ties round the other
way, and the test counts them.

Model level, one randomized flax tree per model (batch 2 at 64^2) goes
through both packages.  Quantization amplifies f32 rounding: a value that
lands within a rounding error of a .5 step rounds either way, and the flip
propagates (JAX's own jitted quantized forward moves p by up to 4.5e-3
when its input moves by 1e-7 relative).  So JAX's forward runs with every
int8 ``QuantConv`` fed the port's own input at that layer: a flip cannot
reach past the next int8 conv, and everything between the pins (the
unpacked Inception branches, the BatchNorm after each int8 conv, the
exact convs) is held within F32_TOL on p in f32 and BF16_TOL in bf16.
JAX's own input at each pinned layer is held to the port's as well, and
every int8 conv is replayed in context: fed the port's own input
activation, JAX's jitted ``QuantConv`` gives the port's output within
1e-5 of the output scale.  The int8 set is JAX's by layer name.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

F32_OP_TOL = 1e-5       # of the output scale, op level and replay
F32_TOL = 1e-4          # on p, model level, f32, int8 inputs pinned
BF16_TOL = 0.015        # on p, model level, bf16, int8 inputs pinned
# a calibrated range below an int8 conv, both packages on one input: a tie
# the two round apart moves the maximum (measured: 1.1e-3 on the engine's
# dense calibration, decoder stage 1)
AMAX_RTOL = 1e-2
MODELS = ("dense", "inception", "deeplabv3")


def _port_conv(kernel, bias, mode="dynamic"):
    """A quantized port module holding one conv named ``c``."""
    from digipathai_tpu_torch.models.unet_decoder import Conv, PreparedModule

    kh, kw, cin, f = kernel.shape
    m = PreparedModule(torch.float32, mode)
    m.add_module("c", Conv(kh, kw, cin, f, use_bias=bias is not None))
    with torch.no_grad():
        m.c.kernel.copy_(torch.from_numpy(np.asarray(kernel)))
        if bias is not None:
            m.c.bias.copy_(torch.from_numpy(np.asarray(bias)))
    return m


def _run(m, x, stride=1, same=True):
    with torch.inference_mode():
        return m._qconv(torch.from_numpy(x), "c", stride=stride,
                        same=same).numpy()


def _exact(kernel, bias, x, stride=1):
    """The exact f32 conv (SAME) of the same weights, in numpy via torch."""
    import torch.nn.functional as F

    from digipathai_tpu_torch.models.unet_decoder import same_pad

    xt = same_pad(torch.from_numpy(x), kernel.shape[0], kernel.shape[1],
                  stride)
    y = F.conv2d(xt.permute(0, 3, 1, 2),
                 torch.from_numpy(kernel).permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1).numpy()
    return y if bias is None else y + bias


class TestQuantConv:
    """``tests/test_quant.py::TestQuantConv`` on the port."""

    def test_wide_conv_error_bounded(self):
        rng = np.random.default_rng(0)
        x = rng.normal(0, 1, (1, 16, 16, 256)).astype(np.float32)
        k = (rng.normal(0, 1, (3, 3, 256, 128)) / 48).astype(np.float32)
        b = rng.normal(0, 0.1, 128).astype(np.float32)
        yq, ye = _run(_port_conv(k, b), x), _exact(k, b, x)
        err = np.abs(yq - ye).max() / np.abs(ye).max()
        assert err < 0.03, err  # int8 symmetric: about 1-2 %

    @pytest.mark.parametrize("cin,f,groups,dilation", [
        (64, 64, 1, 1), (256, 64, 1, 1),          # narrow
        (256, 256, 256, 1),                       # depthwise
        (256, 256, 1, 2),                         # dilated
    ], ids=["narrow", "narrow_out", "depthwise", "dilated"])
    def test_ineligible_convs_take_the_exact_path(self, cin, f, groups,
                                                   dilation):
        from digipathai_tpu_torch.models import quant
        from digipathai_tpu_torch.models.unet_decoder import Conv, PreparedModule

        assert not quant.eligible(cin, f, groups, dilation)
        assert quant.eligible(192, 192) and quant.eligible(2080, 192)
        if dilation == 1:
            # a depthwise kernel is (3, 3, 1, C): its cin of 1 keeps it
            # exact (the port's only dilated convs are DeepLab's depthwise)
            m = PreparedModule(torch.float32, True)
            m.add_module("c", Conv(3, 3, cin // groups, f))
            assert not m._quantizes("c")

    def test_strided_quant_conv_matches_shape_and_value(self):
        rng = np.random.default_rng(3)
        x = rng.normal(0, 1, (1, 16, 16, 192)).astype(np.float32)
        k = (rng.normal(0, 1, (3, 3, 192, 192)) / 42).astype(np.float32)
        yq = _run(_port_conv(k, None), x, stride=2)
        ye = _exact(k, None, x, stride=2)
        assert yq.shape == ye.shape == (1, 8, 8, 192)
        assert np.abs(yq - ye).max() / np.abs(ye).max() < 0.03


class TestCalibration:
    """``tests/test_quant.py::TestQuantizedModel`` on the port."""

    @staticmethod
    def _net(mode):
        from digipathai_tpu_torch.models.unet_decoder import (
            Conv, PreparedModule, init_params)

        class Net(PreparedModule):
            def __init__(self):
                super().__init__(torch.float32, mode)
                self.c1 = Conv(3, 3, 256, 256)
                self.c2 = Conv(3, 3, 256, 256)

            def forward(self, x):
                return self._qconv(torch.relu(self._qconv(x, "c1")), "c2")

        return init_params(Net(), seed=0)

    def test_static_calibrated_matches_dynamic_on_calib_input(self):
        from digipathai_tpu_torch.models.quant import calibrate, set_calib

        x = torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (1, 16, 16, 256)).astype(np.float32))
        dyn, st = self._net(True), self._net("static")
        calib = calibrate(self._net("static"), [x])
        assert set(calib) == {"c1", "c2"}
        set_calib(st, calib)
        with torch.inference_mode():
            np.testing.assert_array_equal(st(x).numpy(), dyn(x).numpy())
            # out of range: the clip keeps the error bounded
            y2d, y2s = dyn(x * 1.5).numpy(), st(x * 1.5).numpy()
        assert np.abs(y2s - y2d).max() / np.abs(y2d).max() < 0.1

    def test_static_requires_calibration(self):
        net, x = self._net("static"), torch.zeros(1, 8, 8, 256)
        with pytest.raises(ValueError, match="calibrated"):
            with torch.inference_mode():
                net(x)

    def test_calib_is_outside_the_state(self):
        """The ranges are no part of ``state_dict`` (so not of the .h5
        template or the .npz cache), and the bridge carries a 'calib'
        collection."""
        from digipathai_tpu_torch.models.bridge import (flax_to_torch,
                                                         torch_to_flax)
        from digipathai_tpu_torch.models.quant import calib_of, calibrate

        m = self._net("static")
        calib = calibrate(m, [torch.ones(1, 8, 8, 256)])
        assert not any("amax" in k for k in m.state_dict())
        tree = torch_to_flax(m)
        other = flax_to_torch({**tree, "calib": calib}, self._net("static"))
        assert calib_of(other) == calib
        with pytest.raises(KeyError):
            flax_to_torch({**tree, "calib": {"nope": {"amax": 1.0}}},
                          self._net("static"))


def _ties(a, amax):
    """How many values of ``a`` quantize differently with the scale
    ``amax / 127`` (eager JAX) and ``amax * f32(1/127)`` (jitted JAX and
    the port)."""
    from digipathai_tpu_torch.models.quant import INV127

    amax = np.maximum(np.float32(amax), np.float32(1e-12))
    eager = amax / np.float32(127.0)
    port = amax * np.float32(INV127)
    return int((np.round(a / eager) != np.round(a / port)).sum())


@pytest.mark.parametrize("case", ["k3", "k3_s2", "k1", "k1_s2_valid", "k1x7"])
def test_op_matches_jax_quant_conv(case):
    """Dynamic and static (with JAX's calibrated amax) against JAX's jitted
    QuantConv/QuantConvStatic within F32_OP_TOL; against eager JAX, the
    outputs move only where a tie flipped (one weight of "k3" on this
    input, none elsewhere)."""
    from digipathai_tpu.models.quant import (QuantConv, QuantConvCalib,
                                             QuantConvStatic)

    cin, f, kh, kw, s, pad = {
        "k3": (256, 256, 3, 3, 1, "SAME"),
        "k3_s2": (320, 384, 3, 3, 2, "SAME"),
        "k1": (2080, 192, 1, 1, 1, "SAME"),
        "k1_s2_valid": (728, 1024, 1, 1, 2, "VALID"),
        "k1x7": (192, 224, 1, 7, 1, "SAME"),
    }[case]
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 16, 16, cin)).astype(np.float32)
    kw_ = dict(features=f, kernel_size=(kh, kw), strides=(s, s),
               padding=pad, dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, QuantConv(**kw_).init(
        jax.random.PRNGKey(0), x))
    v["params"]["bias"] = rng.normal(0, 0.1, f).astype(np.float32)
    calib = QuantConvCalib(**kw_).apply(v, x, mutable=["calib"])[1]["calib"]
    k = v["params"]["kernel"]
    ties = _ties(k, np.abs(k).max(axis=(0, 1, 2)))
    for mode, ctor, vv in (("dynamic", QuantConv, v),
                           ("static", QuantConvStatic, {**v, "calib": calib})):
        want = np.asarray(jax.jit(ctor(**kw_).apply)(vv, x))
        eager = np.asarray(ctor(**kw_).apply(vv, x))
        m = _port_conv(v["params"]["kernel"], v["params"]["bias"], mode)
        if mode == "static":
            m.c.amax = torch.tensor(float(calib["amax"]))
        got = _run(m, x, stride=s, same=pad == "SAME")
        scale = np.abs(want).max()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= F32_OP_TOL * scale, mode
        # against eager JAX, the values whose rounding flips between
        # amax / 127 and amax * f32(1/127) move the outputs by a step
        amax = (np.abs(x).max() if mode == "dynamic"
                else np.float32(calib["amax"]))
        flips = ties + _ties(x, amax)
        assert flips <= 1e-4 * (k.size + x.size), (mode, flips)
        moved = np.abs(got - eager) > F32_OP_TOL * scale
        assert moved.any() == (flips > 0), mode
        assert np.abs(got - eager).max() <= 0.03 * scale, mode


@pytest.fixture(scope="module")
def trees():
    """One randomized flax tree per model (DeepLab's logits scaled 20x so
    its probabilities spread), an input, and a cache of pinned forwards."""
    from tests.torch_parity import model_variables, randomize

    out = {}
    for i, name in enumerate(MODELS):
        v = randomize(model_variables(name, 64), i + 1)
        if name == "deeplabv3":
            v["params"]["custom_logits_semantic"]["kernel"] *= 20.0
        out[name] = v
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    return out, x, {}


def _port_model(trees, name, dtype, mode=True):
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model

    return flax_to_torch(trees[0][name], build_model(
        name, dtype=dtype, quantized=mode).module).eval()


def _replay(port_model, x):
    """Every int8 conv of one forward of ``port_model``: (name, its input,
    stride, padding, its output), recorded in order."""
    from digipathai_tpu_torch.models.unet_decoder import PreparedModule

    calls = []
    real = PreparedModule._qconv

    def spy(self, xi, name, stride=1, same=True):
        y = real(self, xi, name, stride, same)
        calls.append((name, xi.float().numpy(), stride,
                      "SAME" if same else "VALID", y.float().numpy()))
        return y

    PreparedModule._qconv = spy
    try:
        with torch.inference_mode():
            p = port_model(torch.from_numpy(x))
    finally:
        PreparedModule._qconv = real
    return p.float().numpy(), calls


def _pinned(trees, name, dtype):
    """The port's dynamic int8 forward of ``name`` in ``dtype`` and JAX's,
    jitted, with every int8 ``QuantConv`` of JAX's fed the port's own
    input at that layer (so a rounding tie flipped upstream cannot reach
    past the next int8 conv).  Returns (port p, its int8 calls, JAX's p,
    JAX's own input at each int8 layer, JAX's calib collection in f32 --
    the ``"calib"`` build, whose forward is the dynamic one -- else
    None)."""
    import flax.linen as nn

    from digipathai_tpu.models.quant import QuantConv
    from digipathai_tpu.models.registry import build_model

    vs, x, cache = trees
    key = (name, str(dtype))
    if key not in cache:
        f32 = dtype == torch.float32
        p, calls = _replay(_port_model(trees, name, dtype), x)
        pins = {c[0]: c[1] for c in calls}
        module = build_model(name, dtype=jnp.float32 if f32 else jnp.bfloat16,
                             quantized="calib" if f32 else True).module

        def apply(v, xx, pins):
            def pin(next_fun, args, kwargs, context):
                m = context.module
                if (context.method_name == "__call__"
                        and isinstance(m, QuantConv) and m.name in pins):
                    m.sow("intermediates", "x", args[0])
                    args = (pins[m.name].astype(args[0].dtype), *args[1:])
                return next_fun(*args, **kwargs)

            with nn.intercept_methods(pin):
                return module.apply(
                    v, xx, train=False,
                    mutable=["intermediates"] + (["calib"] if f32 else []))

        want, upd = jax.jit(apply)(vs[name], jnp.asarray(x), pins)
        upd = jax.tree_util.tree_map(np.asarray, upd)
        own = {k: v["x"] for k, v in upd["intermediates"].items()}
        assert own.keys() == pins.keys() and all(
            len(v) == 1 for v in own.values())  # every pin used once
        cache[key] = (p, calls, np.asarray(want, np.float32),
                      {k: v[0].astype(np.float32) for k, v in own.items()},
                      upd.get("calib"))
    return cache[key]


@pytest.mark.parametrize("name", MODELS)
def test_model_f32_matches_jax(trees, name):
    """The quantized f32 forward within F32_TOL of JAX's on p, each int8
    conv's input pinned to the port's; between the pins JAX computes each
    int8 conv's input within F32_OP_TOL of the port's (the first from the
    image); each int8 conv, replayed on its own input, within F32_OP_TOL
    of JAX's jitted QuantConv; the int8 set is JAX's (the names JAX's
    calib collection records)."""
    from digipathai_tpu.models.quant import QuantConv

    vs, x, _ = trees
    p, calls, want, own, jax_calib = _pinned(trees, name, torch.float32)
    err = np.abs(p[..., 1] - want[..., 1]).max()
    assert err <= F32_TOL, err

    names = [c[0] for c in calls]
    assert len(names) == len(set(names))  # each int8 conv runs once
    assert set(names) == set(jax_calib)

    fns = {}
    params = vs[name]["params"]
    for layer, xi, stride, pad, y in calls:
        assert np.abs(own[layer] - xi).max() <= F32_OP_TOL * np.abs(
            xi).max(), layer
        k = params[layer]["kernel"]
        bias = params[layer].get("bias")
        key = (k.shape, stride, pad, bias is not None, xi.shape)
        if key not in fns:
            conv = QuantConv(k.shape[-1], k.shape[:2], strides=(stride,) * 2,
                             padding=pad, use_bias=bias is not None,
                             dtype=jnp.float32)
            fns[key] = jax.jit(conv.apply)
        ref = np.asarray(fns[key](
            {"params": {"kernel": k, **({"bias": bias}
                                        if bias is not None else {})}}, xi))
        assert np.abs(y - ref).max() <= F32_OP_TOL * np.abs(ref).max(), layer


@pytest.mark.parametrize("name", ["dense", "inception"])
def test_kernel_calls_skip_the_int8_convs(trees, name):
    """Quantized U-Nets leave the conv kernel exactly for their int8 conv
    blocks: the kernel calls of a forward are ``kernel_calls(...,
    quantized=True)``, and the fused stages (N == 1) stay on the stage
    kernel."""
    from unittest import mock

    from digipathai_tpu_torch.models import densenet_unet, inception_unet
    from digipathai_tpu_torch.ops import conv_fused, stage_fused

    calls = {"dense": densenet_unet, "inception": inception_unet}[
        name].kernel_calls
    for n, fused in ((2, 0), (1, 5)):
        m = _port_model(trees, name, torch.float32)
        m.fused_stages = fused
        seen = []

        def conv(x, k, *a, **kw):
            seen.append(("conv", (*x.shape, k.f, k.pm is not None)))
            return conv_fused.fused_conv3x3_plain(x, k, *a, **kw)

        def stage(y, ka, *a, **kw):
            sk = a[-1]
            seen.append(("stage", (*y.shape, 0 if sk is None else
                                   sk.shape[-1], ka.f)))
            return stage_fused.fused_up_stage_plain(y, ka, *a, **kw)

        with mock.patch.object(conv_fused, "fused_conv3x3", conv), \
                mock.patch.object(stage_fused, "fused_up_stage", stage), \
                torch.inference_mode():
            m(torch.from_numpy(trees[1][:n]))
        want = [(k, sh) for k, sh, count in calls(n, 64, fused,
                                                  quantized=True)
                for _ in range(count)]
        assert seen == want
        exact = [c for k, _, c in calls(n, 64, fused) if k == "conv"]
        assert len([c for c in seen if c[0] == "conv"]) == sum(exact) - (
            4 if fused == 0 else 0)


@pytest.mark.parametrize("name", MODELS)
def test_model_bf16_matches_jax(trees, name):
    """The quantized bf16 forward within BF16_TOL of JAX's on p, each int8
    conv's input pinned to the port's."""
    p, _, want, _, _ = _pinned(trees, name, torch.bfloat16)
    err = np.abs(p[..., 1] - want[..., 1]).max()
    assert err <= BF16_TOL, err


@pytest.mark.parametrize("name", MODELS)
def test_calibrate_matches_jax(trees, name):
    """``calibrate`` records JAX's layer names, and at every layer the
    range of the input JAX computes there (the pinned forward's): the
    first int8 layer's (from the image, no pin above it) within 1e-6,
    the others within F32_OP_TOL."""
    from digipathai_tpu_torch.models import quant

    x = trees[1]
    _, _, _, own, want = _pinned(trees, name, torch.float32)
    port = _port_model(trees, name, torch.float32, "static")
    order = []
    real = quant.quantize_activation

    def spy(xi, mode, conv, layer=""):
        order.append(layer)
        return real(xi, mode, conv, layer)

    quant.quantize_activation = spy
    try:
        got = quant.calibrate(port, [torch.from_numpy(x)])
    finally:
        quant.quantize_activation = real
    assert set(got) == set(want)
    for layer in got:
        rtol = 1e-6 if layer == order[0] else F32_OP_TOL
        np.testing.assert_allclose(float(got[layer]["amax"]),
                                   np.abs(own[layer]).max(), rtol=rtol,
                                   err_msg=layer)
        # JAX's calib collection holds the range of the pinned input
        np.testing.assert_allclose(float(got[layer]["amax"]),
                                   float(want[layer]["amax"]), rtol=1e-6,
                                   err_msg=layer)
    # calibrated, the static model runs
    with torch.inference_mode():
        assert torch.isfinite(port(torch.from_numpy(x))).all()


def test_quant_spec_matches_jax():
    """``_parse_quant_spec``, ``_resolve_quant`` and ``_quant_tag`` give
    JAX's values for the strings of ``tests/test_quant.py``."""
    from digipathai_tpu.engine import segmentation as j
    from digipathai_tpu_torch.engine import segmentation as t

    for spec in ("deeplabv3:static", "deeplabv3:static,dense:dynamic",
                 "inception:off", "static", "my_deeplabv3_v2:calib"):
        assert t._parse_quant_spec(spec) == j._parse_quant_spec(spec)
    for bad in ("dense:int4",):
        with pytest.raises(ValueError):
            t._parse_quant_spec(bad)
    for q, key in (("deeplabv3:static", "deeplabv3"),
                   ("deeplabv3:static", "dense"), ({"dense": True}, "dense"),
                   ("static", "inception"), (False, "dense")):
        assert t._resolve_quant(q, key) == j._resolve_quant(q, key)
    run = ("dense", "inception")
    for q in ({"dense": True, "deeplabv3": "static"},
              "deeplabv3:static,dense:dynamic", "inception:off", {}, False,
              "static", True, "deeplabv3:static"):
        assert t._quant_tag(q) == j._quant_tag(q), q
        for keys in (run, ("deeplabv3",)):
            assert t._quant_tag(q, keys=keys) == j._quant_tag(q, keys=keys)


def test_engine_static_amax_matches_jax(tmp_path, monkeypatch):
    """``quantized="dense:static"``: both engines auto-calibrate dense on
    the same tissue patches with the same weights (written as a .h5), and
    record the same layers' ranges: the first within 1e-6, the rest within
    AMAX_RTOL.  Each engine stops once it has calibrated."""
    from digipathai_tpu.engine import segmentation as jseg
    from digipathai_tpu.models import quant as jquant
    from digipathai_tpu.models import registry as jreg
    from digipathai_tpu_torch.engine import segmentation as tseg
    from digipathai_tpu_torch.models import quant as tquant
    from tests.fixtures import make_synthetic_slide
    from tests.test_torch_convert_h5 import write_dense_h5

    monkeypatch.setenv("DPAI_OFFLINE", "1")
    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    slide = str(tmp_path / "q-slide.tiff")
    make_synthetic_slide(slide, 256, 192, seed=0)
    tree = write_dense_h5("colon")
    # JAX's template from shapes alone (its init runs a whole forward)
    monkeypatch.setattr(jreg.ModelBundle, "init",
                        lambda self, patch_size, seed=0: tree)

    class Calibrated(Exception):
        pass

    seen = {}

    def spy(key, real):
        def wrapped(*a, **kw):
            seen[key] = real(*a, **kw)
            raise Calibrated
        return wrapped

    monkeypatch.setattr(jquant, "calibrate", spy("jax", jquant.calibrate))
    monkeypatch.setattr(tquant, "calibrate", spy("torch", tquant.calibrate))
    kw = dict(patch_size=64, stride_size=32, batch_size=4, mode="colon",
              supertile=128, quantized="dense:static",
              probs_path=str(tmp_path / "p.tiff"),
              mask_path=str(tmp_path / "m.tiff"),
              uncertainty_path=str(tmp_path / "u.tiff"))
    with pytest.raises(Calibrated):
        jseg.getSegmentation(slide, **kw, data_parallel=False,
                             compute_dtype=jnp.float32)
    with pytest.raises(Calibrated):
        tseg.getSegmentation(slide, **kw, compute_dtype=torch.float32,
                             device="cpu")
    want = jax.tree_util.tree_map(np.asarray, seen["jax"])
    got = seen["torch"]
    assert set(got) == set(want) and len(got) == 6
    # pool3_conv is the first int8 conv: no int8 conv feeds it
    np.testing.assert_allclose(float(got["pool3_conv"]["amax"]),
                               float(want["pool3_conv"]["amax"]), rtol=1e-6)
    for layer in got:
        np.testing.assert_allclose(float(got[layer]["amax"]),
                                   float(want[layer]["amax"]),
                                   rtol=AMAX_RTOL, err_msg=layer)
