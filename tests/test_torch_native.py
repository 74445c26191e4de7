"""The port's binding of the native host-runtime library
(toypathtracer_torch/native.py): tests/test_native.py's five contracts,
and the port's build beside the JAX package's.

The library is built with g++ from native/tptnative.cpp into
build/torch_host/ at first use; the encoders agree with io.py's numpy
curves (off by one on < 1% of texels where libm's powf and numpy's pow
round the 0.5 quantisation boundary apart), and with the JAX package's
build of the same source byte for byte.
"""

import numpy as np
import pytest

from toypathtracer_tpu import io as j_io
from toypathtracer_tpu import native as j_native
from toypathtracer_torch import io as image_io
from toypathtracer_torch import native
from toypathtracer_torch.ops import _build

RNG = np.random.default_rng(7)
IMG = (RNG.uniform(-0.1, 1.3, (16, 32, 3))).astype(np.float32)


def test_native_srgb_matches_numpy():
    got = native.srgb_encode(IMG)
    srgb = image_io.linear_to_srgb(IMG)
    want = np.clip(srgb * 255.0 + 0.5, 0, 255).astype(np.uint8)[::-1]
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_native_srgb_cheap_matches_numpy():
    got = native.srgb_encode(IMG, cheap=True)
    srgb = image_io.linear_to_srgb_cheap(IMG)
    want = np.clip(srgb * 255.0 + 0.5, 0, 255).astype(np.uint8)[::-1]
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1


def test_native_tga_payload_order():
    got = native.srgb_encode_tga(IMG)
    top_down = native.srgb_encode(IMG)
    np.testing.assert_array_equal(got, top_down[::-1][:, :, ::-1])


def test_image_metrics():
    a = np.zeros((8, 8, 3), np.float32)
    b = a.copy()
    b[0, 0, 0] = 0.5
    m = native.image_metrics(a, b, tol=0.1)
    np.testing.assert_allclose(m["max_abs"], 0.5)
    assert m["n_over_tol"] == 1
    np.testing.assert_allclose(m["mean_abs"], 0.5 / a.size)


def test_progressive_blend_matches_reference_formula():
    accum = RNG.uniform(0, 1, (4, 4, 3)).astype(np.float32)
    accum[0, 0, 0] = np.nan  # the NaN guard
    frame = RNG.uniform(0, 1, (4, 4, 3)).astype(np.float32)
    out = native.progressive_blend(accum.copy(), frame, 0.75)
    prev = np.where(np.isfinite(accum), accum, 0.0)
    np.testing.assert_allclose(out, prev * 0.75 + frame * 0.25, rtol=1e-6)


@pytest.mark.parametrize("cheap", [False, True])
def test_same_bytes_as_the_jax_package(cheap):
    """The port's to_u8 (its own build of the library) and the JAX
    package's: byte for byte."""
    np.testing.assert_array_equal(image_io.to_u8(IMG, cheap=cheap),
                                  j_io.to_u8(IMG, cheap=cheap))
    if j_native.available():
        np.testing.assert_array_equal(native.srgb_encode_tga(IMG, cheap),
                                      j_native.srgb_encode_tga(IMG, cheap))


def test_built_beside_the_port_not_the_jax_package():
    assert native.available()
    lib = native._load()
    assert str(_build.HOST_BUILD_DIR) in lib._name
    assert "toypathtracer_tpu" not in lib._name
