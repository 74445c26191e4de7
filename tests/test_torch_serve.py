"""The port's live viewer (toypathtracer_torch/serve.py) on the CPU:
tests/test_serve.py's six contracts -- frames advance, the HUD's format,
flag toggles reset the accumulation (TestWin.cpp:424-431), the backend
switch resets it on the session's device, the HTTP surface, the PNG
encoder, batched frames equal to single ones -- and the command line's
viewer defaulting to the card."""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from toypathtracer_tpu import io as j_io
from toypathtracer_torch import (FLAG_ANIMATE, FLAG_PROGRESSIVE,
                                 RenderConfig, make_scene)
from toypathtracer_torch import io as image_io
from toypathtracer_torch.render.wavefront import render_frame_plain
from toypathtracer_torch.serve import Viewer, make_handler, make_viewer, main

torch.set_num_threads(1)

TINY = RenderConfig(width=64, height=40, samples_per_pixel=1, max_depth=3)


def viewer(**kw):
    return Viewer(make_scene(big=False), TINY, device="cpu", **kw)


def test_viewer_steps_and_png():
    v = viewer()
    v.step_once()
    v.step_once()
    png, hud = v.snapshot()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert png == image_io.png_bytes(v.sess.state.accum.numpy())
    assert v.sess.state.frame == 2
    assert "Mrays/s" in hud and "frames 2" in hud
    assert hud.startswith("CPU path tracer ")


def test_toggle_resets_accumulation():
    v = viewer()
    v.step_once()
    v.step_once()
    v.set_flags(animate=True, progressive=True)
    v.step_once()  # applies the toggle, then renders frame 0
    assert v.sess.flags == (FLAG_ANIMATE | FLAG_PROGRESSIVE)
    assert v.sess.state.frame == 1
    v.set_flags(animate=True, progressive=True)  # no change: no reset
    v.step_once()
    assert v.sess.state.frame == 2


def test_backend_toggle_resets_accumulation_on_the_session_device():
    """The 'g' switch (TestWin.cpp:419-423): a switch resets the
    accumulator on the session's own device, a switch to the same name
    does not, an unknown name is refused."""
    fns = {"plain": None, "other": render_frame_plain}
    v = Viewer(make_scene(big=False), TINY, render_fns=fns, backend="plain",
               device="cpu")
    v.step_once()
    v.step_once()
    assert v.set_backend("other") is True
    assert v.set_backend("bogus") is False
    v.step_once()  # applies the switch, resets, renders frame 0
    assert v.backend == "other" and v.sess.render_fn is render_frame_plain
    assert v.sess.state.frame == 1
    assert v.sess.state.accum.device.type == "cpu"
    v.set_backend("other")
    v.step_once()
    assert v.sess.state.frame == 2


def test_http_surface():
    v = viewer()
    v.step_once()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(v))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        page = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"toypathtracer_torch" in page and b"/frame.png" in page
        png = urllib.request.urlopen(base + "/frame.png", timeout=10).read()
        assert png == v.snapshot()[0]
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=10).read())
        assert set(stats) == {"hud", "mray_s", "frames", "animate",
                              "progressive", "backend", "backends"}
        assert stats["frames"] == 1
        assert stats["progressive"] is True and stats["animate"] is False
        assert "Mrays/s" in stats["hud"]
        assert stats["backend"] == "default"
        assert stats["backends"] == ["default"]
        urllib.request.urlopen(base + "/set?animate=1&progressive=1",
                               timeout=10).read()
        v.step_once()
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=10).read())
        assert stats["animate"] is True
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/set?backend=bogus", timeout=10)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_png_roundtrip_matches_writer():
    """png_bytes decodes to to_u8's pixels, the JAX package's bytes."""
    from PIL import Image
    import io as _io
    img = np.random.default_rng(0).uniform(0.0, 1.0, (7, 5, 3)) \
        .astype(np.float32)
    data = image_io.png_bytes(img)
    arr = np.asarray(Image.open(_io.BytesIO(data)))
    np.testing.assert_array_equal(arr, image_io.to_u8(img))
    assert data == j_io.png_bytes(img)


def test_batched_viewer_matches_sequential():
    """batch=3 advances 3 frames a step with the image, rays and counter
    of 3 single steps, bit for bit; animating steps one frame."""
    va = viewer()
    vb = viewer(batch=3)
    va.time_scale = vb.time_scale = 0.0
    for _ in range(3):
        va.step_once()
    vb.step_once()
    assert va.sess.state.frame == vb.sess.state.frame == 3
    assert torch.equal(va.sess.state.accum, vb.sess.state.accum)
    assert vb.timer.frames == 3
    vb.set_flags(animate=True, progressive=True)
    vb.step_once()
    assert vb.sess.state.frame == 1


def test_command_line_viewer(monkeypatch):
    """serve's command line: on the CPU one plain backend; its default
    is the card, which raises without one; the render thread starts and
    stops."""
    import argparse
    args = argparse.Namespace(width=16, height=8, spp=1, max_depth=2,
                              small=True, scaled=0, animate=False, ppl=1,
                              batch=0, backend="auto", device="cpu")
    v, label = make_viewer(args)
    assert label == "plain" and sorted(v.render_fns) == ["plain"]
    assert v.batch == 1 and v.sess.device.type == "cpu"
    v.start()
    v.stop()
    assert v.sess.state.frame >= 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        main(["--width", "16", "--height", "8", "--port", "0"])


def test_viewer_takes_the_jax_backend_names():
    """The JAX viewer's backend names: "jnp" and "pallas" switch to the
    port's plain renderer and the card's kernel where the viewer has them
    (set_backend), and serve's --backend jnp runs the plain renderer on
    the CPU while --backend pallas stops there, naming the card."""
    import argparse
    fns = {"cuda": render_frame_plain, "plain": None}
    v = Viewer(make_scene(big=False), TINY, render_fns=fns, backend="plain",
               device="cpu")
    assert v.set_backend("pallas") is True
    v.step_once()
    assert v.backend == "cuda"
    assert v.set_backend("jnp") is True
    v.step_once()
    assert v.backend == "plain"
    cpu_only = viewer(render_fns={"plain": None})
    assert cpu_only.set_backend("jnp") is True
    assert cpu_only.set_backend("pallas") is False

    def args(backend):
        return argparse.Namespace(width=16, height=8, spp=1, max_depth=2,
                                  small=True, scaled=0, animate=False, ppl=1,
                                  batch=0, backend=backend, device="cpu")
    v, label = make_viewer(args("jnp"))
    assert label == "plain" and sorted(v.render_fns) == ["plain"]
    v.step_once()
    assert v.sess.state.frame == 1 and v.sess.device.type == "cpu"
    with pytest.raises(SystemExit, match="--backend pallas runs the card"):
        make_viewer(args("pallas"))
