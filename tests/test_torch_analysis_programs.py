"""Parity of the port's analysis programs (VGG-16, ZF) with the JAX package's.

Each layer the nets run is held against the jax operation the reference
calls, on the same inputs made with numpy: the SAME-padded conv against
``jax.lax.conv_general_dilated`` (stride-2 pads are asymmetric), the
resize against ``jax.image.resize(..., "linear")`` (antialiased when it
downsamples), the pool against ``reduce_window``; then both whole nets at
640x480 with the reference's ``init_*(PRNGKey(0))`` weights carried across
by `analysis_params_from_plain`.  Both packages compute in float32 and
differ in the order of their sums: convs within 1e-5 absolute (inputs
O(1)), pools exactly, the nets' logits within 1e-4 of the largest logit.
A resize's filter weights are linear in the sample's source coordinate,
which both packages round to float32, each its own way: pixels in [0, 1]
are held to one float32 spacing at the largest source coordinate (3.1e-5
for a 320-wide frame; the identity resize exactly).  The analytic counts
are pure Python and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.streams import FrameSize as RefFrameSize
from repro.models import analysis_programs as ref

from repro_torch.core.streams import FrameSize
from repro_torch.interop import analysis_params_from_plain
from repro_torch.models import analysis_programs as ap

FRAME_SIZES = ((640, 480), (320, 240), (1280, 720))
LAYER_ATOL = 1e-5
LOGIT_RTOL = 1e-4


@pytest.mark.parametrize("program_id", ["vgg16", "zf"])
@pytest.mark.parametrize("size", FRAME_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_program_counts_and_frames_equal_reference(program_id, size):
    fsz, ref_fsz = FrameSize(*size), RefFrameSize(*size)
    assert ap.program_flops(program_id, fsz) == ref.program_flops(program_id, ref_fsz)
    assert ap.program_params(program_id) == ref.program_params(program_id)
    assert ap.program_params(program_id, num_classes=7) == ref.program_params(
        program_id, num_classes=7)
    frame = ap.make_frame(fsz)
    assert frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, ref.make_frame(ref_fsz))


def test_unknown_program_raises():
    with pytest.raises(KeyError):
        ap.program_flops("resnet", FrameSize(640, 480))
    with pytest.raises(KeyError):
        ap.program_params("resnet")


@pytest.mark.parametrize("program_id", ["vgg16", "zf"])
def test_init_shapes_match_reference(program_id):
    init, ref_init = {"vgg16": (ap.init_vgg16, ref.init_vgg16),
                      "zf": (ap.init_zf, ref.init_zf)}[program_id]
    port = init(torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(ref_init, jax.random.PRNGKey(0))
    assert len(port["convs"]) == len(want["convs"])
    for p, w in zip(port["convs"], want["convs"]):
        kh, kw, cin, cout = w["w"].shape
        assert tuple(p["w"].shape) == (cout, cin, kh, kw)
        assert tuple(p["b"].shape) == w["b"].shape
    for p, w in zip(port["fc"], want["fc"], strict=True):
        assert tuple(p["w"].shape) == w["w"].shape
        assert tuple(p["b"].shape) == w["b"].shape
    n = sum(t.numel() for part in port.values() for layer in part for t in layer.values())
    assert n == ap.program_params(program_id)
    # Seeded: the same generator seed draws the same weights.
    again = init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(port["fc"][0]["w"], again["fc"][0]["w"])


#: (spatial size, kernel, stride): ZF's (224, 7, 2) and (56, 5, 2), and
#: even and odd sizes for every kernel and stride.
CONV_CASES = [(224, 7, 2), (56, 5, 2)] + [
    (n, k, s) for k in (3, 5, 7) for s in (1, 2) for n in (14, 15)
]


@pytest.mark.parametrize("n,k,s", CONV_CASES)
def test_conv_matches_xla_same_padding(n, k, s):
    rng = np.random.RandomState(n * 100 + k * 10 + s)
    cin, cout = 3, 4
    x = rng.standard_normal((1, n, n + 1, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) / k).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, window_strides=(s, s), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + b
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    bt = torch.from_numpy(b)
    # `_conv` applies relu; conv = relu(conv) - relu(-conv) keeps both signs.
    got = ap._conv(xt, wt, bt, stride=s) - ap._conv(xt, -wt, -bt, stride=s)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL, rtol=0)
    # The port's own `_conv` against the reference's.
    np.testing.assert_allclose(
        ap._conv(xt, wt, bt, stride=s).permute(0, 2, 3, 1).numpy(),
        np.asarray(ref._conv(x, w, b, stride=s)), atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("n,k,s", [(224, 7, 2), (56, 5, 2), (15, 3, 1), (14, 3, 2)])
def test_same_pads_put_the_extra_row_last(n, k, s):
    lo, hi = ap.same_pads(n, k, s)
    assert hi - lo in (0, 1)
    assert (n + lo + hi - k) // s + 1 == -(-n // s)


@pytest.mark.parametrize("size", FRAME_SIZES + ((224, 224),),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_preprocess_matches_jax_image_resize(size):
    frame = ap.make_frame(FrameSize(*size))
    want = np.asarray(ref._preprocess(frame, 224))  # (1, 224, 224, 3)
    got = ap._preprocess(frame, 224, torch.device("cpu")).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    atol = float(np.spacing(np.float32(max(size))))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    if size == (224, 224):  # the identity, exactly
        np.testing.assert_array_equal(got[0], frame.astype(np.float32) / 255.0)


def test_zf_head_resize_is_the_identity_at_7x7():
    rng = np.random.RandomState(7)
    x = rng.standard_normal((1, 7, 7, 5)).astype(np.float32)
    got = ap._resize(torch.from_numpy(x).permute(0, 3, 1, 2), 7, 7)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), x)
    np.testing.assert_allclose(
        np.asarray(jax.image.resize(x, (1, 7, 7, 5), "linear")), x, atol=0, rtol=0)


def test_maxpool_matches_reduce_window_at_an_odd_size():
    rng = np.random.RandomState(3)
    x = rng.standard_normal((1, 15, 9, 6)).astype(np.float32)
    want = np.asarray(ref._maxpool(jnp.asarray(x)))
    got = ap._maxpool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 7, 4, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("program_id", ["vgg16", "zf"])
def test_forward_matches_reference_at_640x480(program_id):
    init, forward = {"vgg16": (ref.init_vgg16, ref.vgg16_forward),
                     "zf": (ref.init_zf, ref.zf_forward)}[program_id]
    tree = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    frame = ref.make_frame(RefFrameSize(640, 480))
    want = np.asarray(jax.jit(lambda f: forward(tree, f))(frame))
    params = analysis_params_from_plain(program_id, tree, device="cpu")
    port_forward = {"vgg16": ap.vgg16_forward, "zf": ap.zf_forward}[program_id]
    got = port_forward(params, frame).numpy()
    assert got.shape == want.shape == (1, 105)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=LOGIT_RTOL * scale, rtol=0)


def test_analysis_params_from_plain_rejects_unknown_programs():
    with pytest.raises(KeyError):
        analysis_params_from_plain("resnet", {"convs": [], "fc": []}, device="cpu")


@pytest.mark.parametrize("program_id", ["vgg16", "zf"])
def test_programs_run_seeded_nets_on_the_cpu_when_asked(program_id):
    frame = ap.make_frame(FrameSize(320, 240))
    out = ap.PROGRAMS[program_id](frame, device="cpu")
    assert out.device.type == "cpu" and out.shape == (1, 105)
    init, forward = {"vgg16": (ap.init_vgg16, ap.vgg16_forward),
                     "zf": (ap.init_zf, ap.zf_forward)}[program_id]
    want = forward(init(torch.Generator().manual_seed(0), device="cpu"), frame)
    assert torch.equal(out, want)


def test_programs_need_the_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    frame = ap.make_frame(FrameSize(320, 240))
    for program_id in ("vgg16", "zf"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ap.PROGRAMS[program_id](frame)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ap.init_zf(torch.Generator().manual_seed(0))
