"""The port's slice as a whole on the CPU: progressive sessions against
the JAX package's progressive_step, the accumulation contracts, the HUD,
the CLI, and the port's independence from JAX.

Session tolerances at tests/test_wavefront.py's CFG (64x36, spp 4,
depth 10), measured over 3 frames then gated at about twice that: a
1-ulp transcendental difference flips a few Monte-Carlo decisions per
frame at this depth, so ray counts differ by up to 6.4e-4 relative (gate
1.5e-3), 99.3% of pixels agree within 1e-4 (gate 98.5%), mean |diff|
up to 2.1e-5 (gate 5e-5).  The accumulation contracts are exact.
"""

import ast
import json
import os
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import make_scene as j_make_scene
from toypathtracer_tpu import profiling as j_profiling
from toypathtracer_tpu.render import frame as j_frame
from toypathtracer_torch import (FLAG_ANIMATE, FLAG_PROGRESSIVE,
                                 RenderConfig, make_scene, profiling)
from toypathtracer_torch.cli import main as cli_main
from toypathtracer_torch.ops import cuda_render
from toypathtracer_torch.render import frame as frame_mod
from toypathtracer_torch.render.frame import RenderSession
from toypathtracer_torch.render.wavefront import render_frame_plain

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = RenderConfig(width=24, height=12, samples_per_pixel=1, max_depth=3)


def test_session_matches_jax_progressive_step():
    cfg, jcfg = RenderConfig(width=64, height=36), JConfig(width=64,
                                                           height=36)
    sess = RenderSession(make_scene(big=True), cfg, device="cpu")
    jscene = j_make_scene(big=True)
    st = j_frame.init_frame_state(jcfg)
    for _ in range(3):
        img, rays = sess.step(0.0)
        img = img.clone().numpy()
        st, jimg, jrays = j_frame.progressive_step(
            st, jscene, jnp.float32(0.0), jcfg, FLAG_PROGRESSIVE)
        jimg = np.asarray(jimg)
        assert abs(int(rays) - int(jrays)) <= 1.5e-3 * int(jrays)
        d = np.abs(img - jimg)
        assert (d.max(axis=-1) <= 1e-4).mean() >= 0.985
        assert d.mean() <= 5e-5
    assert sess.state.frame == 3 == int(st.frame)


def test_progressive_blend_contract():
    scene = make_scene(big=False)
    sess = RenderSession(scene, SMALL, device="cpu")
    img1 = sess.step(0.0)[0].clone()
    img2 = sess.step(0.0)[0].clone()
    f0, _ = cuda_render.render_frame(scene, SMALL, 0, device="cpu")
    f1, _ = cuda_render.render_frame(scene, SMALL, 1, device="cpu")
    # frame 0: lerpFac 0 -> the raw frame; frame 1: the 0.5/0.5 blend
    np.testing.assert_array_equal(img1.numpy(), f0.numpy())
    np.testing.assert_array_equal(img2.numpy(), (f0 * 0.5 + f1 * 0.5).numpy())
    assert sess.state.frame == 2


def test_lerp_factor_matches_jax():
    jcfg = JConfig()
    for frame in (0, 1, 4, 1000):
        for flags in (0, FLAG_PROGRESSIVE, FLAG_PROGRESSIVE | FLAG_ANIMATE,
                      FLAG_ANIMATE):
            want = j_frame.lerp_factor(jnp.int32(frame), flags, jcfg)
            got = frame_mod.lerp_factor(frame, flags, RenderConfig())
            assert np.float32(got) == np.float32(want)


def test_flag_toggle_resets_accumulator():
    sess = RenderSession(make_scene(big=False), SMALL, device="cpu")
    sess.step(0.0)
    sess.set_flags(FLAG_PROGRESSIVE)   # unchanged: keeps accumulating
    assert sess.state.frame == 1
    sess.set_flags(FLAG_PROGRESSIVE | FLAG_ANIMATE)
    assert sess.state.frame == 0
    assert not sess.state.accum.any()
    img, _ = sess.step(1.0)
    animated, _ = cuda_render.render_frame(make_scene(big=False).animate(1.0),
                                           SMALL, 0, device="cpu")
    np.testing.assert_array_equal(img.numpy(), animated.numpy())


def test_nan_guard_on_history():
    scene = make_scene(big=False)
    sess = RenderSession(scene, SMALL, device="cpu")
    sess.step(0.0)
    sess.state.accum[0, 0, 0] = float("nan")
    sess.state.accum[1, 2, 1] = float("inf")
    img, _ = sess.step(0.0)
    assert torch.isfinite(img).all()
    f1, _ = cuda_render.render_frame(scene, SMALL, 1, device="cpu")
    assert img[0, 0, 0] == f1[0, 0, 0] * 0.5
    assert img[1, 2, 1] == f1[1, 2, 1] * 0.5


def test_sum_rays_is_int64():
    sess = RenderSession(make_scene(big=False), SMALL, device="cpu")
    img, rays = sess.steps(0.0, 3)
    assert rays.shape == (3,) and rays.dtype == torch.int64
    assert frame_mod.sum_rays(rays) == int(rays.sum())
    big = torch.full((4,), 2**31 - 1, dtype=torch.int32)
    assert frame_mod.sum_rays(big) == 4 * (2**31 - 1)


@pytest.mark.parametrize("title,seconds,rays,frames", [
    ("CUDA path tracer", 0.0153, 16772198, 7),
    ("CPU path tracer", 0.0, 0, 0),
    ("x", 2.5, 123456789012, 100000),
])
def test_hud_string_byte_identical(title, seconds, rays, frames):
    assert profiling.hud_string(title, seconds, rays, frames) == \
        j_profiling.hud_string(title, seconds, rays, frames)


def test_trace_to_writes_a_trace(tmp_path):
    """profiling.trace_to, JAX's signature on torch.profiler: a render on
    the CPU inside it leaves one Chrome trace file in log_dir, which
    trace_summary reads (no device activity on the CPU: idle share 1);
    kernel_label strips a kernel's return type, namespaces and
    parameters."""
    import inspect
    assert list(inspect.signature(profiling.trace_to).parameters) == \
        list(inspect.signature(j_profiling.trace_to).parameters)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=2)
    with profiling.trace_to(str(tmp_path)) as prof:
        render_frame_plain(make_scene(big=False), cfg, 0)
        with torch.profiler.record_function("frame_1"):
            render_frame_plain(make_scene(big=False), cfg, 1)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and prof is not None
    summary = profiling.trace_summary(tmp_path)
    assert summary["file"] == files[0].name
    assert summary["span_ms"] > 0 and summary["busy_ms"] == 0.0
    assert summary["idle_share"] == 1.0 and summary["kernels"] == {}
    one = profiling.trace_summary(files[0], window="frame_1")
    assert 0 < one["span_ms"] < summary["span_ms"]
    with pytest.raises(ValueError, match="frame_2"):
        profiling.trace_summary(tmp_path, window="frame_2")
    assert profiling.kernel_label(
        "void (anonymous namespace)::merged_render_kernel<4>(float const*, "
        "tpt::RenderParams, tpt::FrameTape)") == "merged_render_kernel<4>"
    assert profiling.kernel_label("void wave_sweep_kernel(float const*, "
                                  "int)") == "wave_sweep_kernel"


def test_trace_summary_device_intervals(tmp_path):
    """trace_summary on a hand-made Chrome trace: overlapping device
    intervals counted once, copies apart from kernels, a window clipping
    what lies outside it, metadata and flow events ignored."""
    ev = [{"ph": "M", "name": "process_name"},
          {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 0,
           "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "step", "ts": 10,
           "dur": 80},
          {"ph": "X", "cat": "kernel", "ts": 20, "dur": 30,
           "name": "void (anonymous namespace)::merged_render_kernel<4>("
                   "float const*, tpt::FrameTape)"},
          {"ph": "X", "cat": "kernel", "ts": 40, "dur": 20,
           "name": "void wave_sweep_kernel(float const*)"},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 80,
           "dur": 40},
          {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 5}]
    f = tmp_path / "x.pt.trace.json"
    f.write_text(json.dumps({"traceEvents": ev}))
    whole = profiling.trace_summary(f)
    assert whole["span_ms"] == pytest.approx(0.120)
    assert whole["busy_ms"] == pytest.approx(0.080)  # 20-60 and 80-120
    assert whole["idle_share"] == pytest.approx(1 - 80 / 120)
    assert whole["kernels"] == {
        "merged_render_kernel<4>": {"ms": pytest.approx(0.030),
                                    "launches": 1},
        "wave_sweep_kernel": {"ms": pytest.approx(0.020), "launches": 1}}
    assert whole["copies_ms"] == pytest.approx(0.040)
    step = profiling.trace_summary(tmp_path, window="step")
    assert step["span_ms"] == pytest.approx(0.080)
    assert step["busy_ms"] == pytest.approx(0.050)  # 20-60 and 80-90
    assert step["copies_ms"] == pytest.approx(0.010)



def test_trace_summary_runtime_calls(tmp_path):
    """trace_summary's "runtime": the host's CUDA runtime and driver calls
    that start inside the window, host ms and calls by name (the traced
    wavefront step's cudaMemGetInfo is read so), those outside it left
    out; device intervals unchanged by them."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "step", "ts": 10,
           "dur": 80},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemGetInfo",
           "ts": 5, "dur": 3},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemGetInfo",
           "ts": 12, "dur": 40},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 60, "dur": 4},
          {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
           "ts": 65, "dur": 2},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 70, "dur": 6},
          {"ph": "X", "cat": "kernel", "ts": 70, "dur": 10,
           "name": "void wave_run_kernel<4, false>(float const*)"}]
    f = tmp_path / "r.pt.trace.json"
    f.write_text(json.dumps({"traceEvents": ev}))
    step = profiling.trace_summary(f, window="step")
    assert step["runtime"] == {
        "cudaMemGetInfo": {"ms": pytest.approx(0.040), "calls": 1},
        "cudaLaunchKernel": {"ms": pytest.approx(0.010), "calls": 2},
        "cuLaunchKernel": {"ms": pytest.approx(0.002), "calls": 1}}
    assert step["kernels"] == {"wave_run_kernel<4, false>": {
        "ms": pytest.approx(0.010), "launches": 1}}
    assert step["busy_ms"] == pytest.approx(0.010)
    assert profiling.trace_summary(f)["runtime"]["cudaMemGetInfo"][
        "calls"] == 2


def test_traced_kernel_by_ptxas_label():
    """traced_kernel finds a trace_summary kernel entry by the kernel's
    ptxas label (bool template arguments as 1/0, no spaces), the
    wavefront sweeps' labels among them; {} where it is not there."""
    from toypathtracer_torch.ops import cuda_grad
    kernels = {"wave_run_kernel<true, false>": {"ms": 1.5, "launches": 3},
               "wave_run_kernel<false, false>": {"ms": 4.0, "launches": 1},
               "wave_sweep_kernel": {"ms": 5.0, "launches": 2},
               "merged_render_kernel<4>": {"ms": 3.0, "launches": 1}}
    labels = cuda_grad.SWEEP_LABELS
    assert profiling.traced_kernel(kernels, labels["runs"]) == {
        "ms": 1.5, "launches": 3}
    assert profiling.traced_kernel(kernels, labels["runs_on_tiles_deal"])[
        "ms"] == 4.0
    assert profiling.traced_kernel(kernels, labels["tiles"])["launches"] == 2
    assert profiling.traced_kernel(kernels, "merged_render_kernel<4>")[
        "ms"] == 3.0
    assert profiling.traced_kernel(kernels, "wave_run_kernel<1,1>") == {}


def test_frame_timer_matches_jax():
    t = profiling.FrameTimer(title="T")
    j = j_profiling.FrameTimer(title="T")
    for i, (dt, rays, n) in enumerate([(0.01, 1000, 1), (0.05, 8000, 4),
                                       (0.3, 90000, 12), (0.02, 3000, 1)]):
        t.add(dt, rays, n)
        j.add(dt, rays, n)
        assert t.hud() == j.hud() and t.frames == j.frames
        assert t.mray_s() == j.mray_s()


def test_cli_cpu_render(tmp_path, capsys):
    from PIL import Image
    out = tmp_path / "out.png"
    assert cli_main(["--device", "cpu", "--width", "32", "--height", "16",
                     "--spp", "1", "--max-depth", "3", "--frames", "2",
                     "--output", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    hud = [ln for ln in lines if re.fullmatch(
        r"CPU path tracer \d+\.\d\dms \(\d+\.\d FPS\) \d+\.\dMrays/s "
        r"\d+\.\d\dMrays/frame frames \d+", ln)]
    assert len(hud) == 2 and hud[-1].endswith("frames 2")
    with Image.open(out) as im:
        assert im.size == (32, 16) and im.mode == "RGB"


def _cli(tmp_path, name, *extra, size=("32", "16")):
    """Run the CLI on the CPU; returns (PNG bytes, rays, stdout lines)."""
    import contextlib
    import io
    out = tmp_path / f"{name}.png"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli_main(["--device", "cpu", "--width", size[0], "--height",
                         size[1], "--spp", "1", "--max-depth", "3",
                         "--output", str(out), *extra]) == 0
    lines = buf.getvalue().splitlines()
    total = [m for m in (re.fullmatch(r"frames \d+-\d+: (\d+) rays", ln)
                         for ln in lines) if m]
    assert len(total) == 1
    return out.read_bytes(), int(total[0].group(1)), lines


def test_cli_resume_equals_a_straight_run(tmp_path):
    """2 frames, --save-state, then --resume and 2 more: the image byte
    for byte and the saved accumulator and counter of 4 frames run
    straight, the rays of frames 3-4 those of the straight run's."""
    from toypathtracer_torch import checkpoint
    s1, s2, s4 = (str(tmp_path / f"{k}.npz") for k in ("s1", "s2", "s4"))
    _, rays12, _ = _cli(tmp_path, "a", "--frames", "2", "--save-state", s1)
    png_b, rays34, lines = _cli(tmp_path, "b", "--frames", "2", "--resume",
                                s1, "--save-state", s2)
    assert "frames 3-4: " in "".join(lines)
    assert [ln for ln in lines if "path tracer" in ln][-1].endswith(
        "frames 4")
    png_c, rays_all, _ = _cli(tmp_path, "c", "--frames", "4",
                              "--save-state", s4)
    assert png_b == png_c and rays12 + rays34 == rays_all
    a = checkpoint.load_frame_state(s2, device="cpu")
    b = checkpoint.load_frame_state(s4, device="cpu")
    assert a.frame == b.frame == 4 and torch.equal(a.accum, b.accum)
    with pytest.raises(SystemExit, match="resume"):
        _cli(tmp_path, "d", "--frames", "1", "--resume", s1,
             size=("16", "16"))


def test_cli_batch_equals_single_frames(tmp_path):
    """--batch 3 over 5 frames (steps of 3 and 2, the HUD line a step in
    per-frame units) gives the image and rays of single frames."""
    png1, rays1, _ = _cli(tmp_path, "one", "--frames", "5")
    png3, rays3, lines = _cli(tmp_path, "three", "--frames", "5",
                              "--batch", "3")
    assert png1 == png3 and rays1 == rays3
    hud = [ln for ln in lines if ln.startswith("CPU path tracer")]
    assert [ln.rsplit(" ", 1)[1] for ln in hud] == ["3", "5"]


def test_cli_parity_backend(tmp_path):
    """--backend parity renders render/parity.render_frame_parity."""
    from toypathtracer_torch.render.parity import render_frame_parity
    png, rays, lines = _cli(tmp_path, "p", "--frames", "1", "--backend",
                            "parity", size=("8", "4"))
    assert lines[0].startswith("backend=parity")
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=1, max_depth=3)
    img, want_rays = render_frame_parity(make_scene(big=True), cfg, 0,
                                         device="cpu")
    from toypathtracer_torch import io as image_io
    assert png == image_io.png_bytes(img.numpy())
    assert rays == int(want_rays)


# tests/test_io_cli.py:57's command line, and :69's common part, with the
# port's --device cpu
JAX_CLI = ["--width", "64", "--height", "8", "--spp", "1", "--max-depth",
           "3", "--small", "--backend", "jnp", "--device", "cpu"]


def test_cli_jax_command_line_renders(tmp_path, capsys):
    """tests/test_io_cli.py:57 against the port: --backend jnp renders with
    the plain PyTorch renderer on --device (one stderr line says so), the
    image that of the default CPU backend."""
    out = str(tmp_path / "cli.tga")
    assert cli_main(JAX_CLI + ["--frames", "2", "--output", out]) == 0
    captured = capsys.readouterr()
    assert os.path.exists(out)
    assert "Mrays/s" in captured.out and "frames 2" in captured.out
    assert captured.out.splitlines()[0].startswith("backend=jnp ")
    err = captured.err.splitlines()
    assert err == ["--backend jnp: the plain PyTorch renderer on cpu"]
    auto = str(tmp_path / "auto.tga")
    assert cli_main([a for a in JAX_CLI if a not in ("--backend", "jnp")]
                    + ["--frames", "2", "--output", auto]) == 0
    assert open(out, "rb").read() == open(auto, "rb").read()


def test_cli_jax_resume_command_lines(tmp_path, capsys):
    """tests/test_io_cli.py:69 against the port: 2 frames with
    --save-state, --resume and 2 more, byte for byte the image of 4
    straight frames, the frame counter resumed."""
    state = str(tmp_path / "state.npz")
    a, b, c = (str(tmp_path / f"{k}.tga") for k in "abc")
    assert cli_main(JAX_CLI + ["--frames", "2", "--save-state", state,
                               "--output", a]) == 0
    assert cli_main(JAX_CLI + ["--frames", "2", "--resume", state,
                               "--output", b]) == 0
    assert "frames 4" in capsys.readouterr().out
    assert cli_main(JAX_CLI + ["--frames", "4", "--output", c]) == 0
    np.testing.assert_array_equal(np.fromfile(b, np.uint8),
                                  np.fromfile(c, np.uint8))


@pytest.mark.parametrize("scaled", [[], ["--scaled", "512"]])
def test_cli_pallas_backend_refuses_the_cpu(tmp_path, scaled):
    """--backend pallas is the card's hand-written kernel: with --device
    cpu the CLI stops with a message naming it, and renders nothing on
    the plain renderer instead."""
    out = tmp_path / "none.png"
    with pytest.raises(SystemExit, match="--backend pallas runs the card"):
        cli_main(["--device", "cpu", "--width", "16", "--height", "8",
                  "--frames", "1", "--backend", "pallas", "--output",
                  str(out), *scaled])
    assert not out.exists()


def test_cli_accepts_the_tpu_knobs(tmp_path, capsys):
    """--tile, --ppl and --merged (the JAX CLI's occupancy knobs) run
    unchanged with the same image, and one stderr line says the card's
    kernel ignores them."""
    png0, rays0, _ = _cli(tmp_path, "k0", "--frames", "1")
    capsys.readouterr()
    png1, rays1, _ = _cli(tmp_path, "k1", "--frames", "1", "--tile",
                          "8,64", "--ppl", "2", "--merged")
    err = capsys.readouterr().err.splitlines()
    assert png0 == png1 and rays0 == rays1
    assert len(err) == 1 and "ignores" in err[0]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "toypathtracer_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "toypathtracer_tpu"), \
                f"{path.relative_to(ROOT)} imports {mod}"


def test_state_and_scene_loading_default_to_the_card(tmp_path, monkeypatch):
    """init_frame_state and load_scene_npz take the card unless the caller
    asks for the CPU, as every other entry point: without a card the
    default raises instead of quietly using the CPU."""
    from toypathtracer_torch.scene import load_scene_npz
    from toypathtracer_tpu.checkpoint import save_scene as j_save_scene
    path = str(tmp_path / "scene.npz")
    j_save_scene(path, j_make_scene(big=False))
    state = frame_mod.init_frame_state(SMALL, device="cpu")
    assert state.accum.device.type == "cpu" and state.frame == 0
    assert load_scene_npz(path, device="cpu").center.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        frame_mod.init_frame_state(SMALL)
    with pytest.raises(RuntimeError, match="device"):
        load_scene_npz(path)
