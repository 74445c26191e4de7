"""Live progressive viewer: the interactive frontend (counterpart of
toypathtracer_tpu/serve.py).

The reference's interactive frontends -- the Win32/D3D11 app
(Cpp/Windows/TestWin.cpp:384-432), the MetalKit app (Cpp/Apple/
Renderer.mm:272-316) and most directly the Emscripten/HTML one
(Cpp/Emscripten/toypathtracer.html:96-128: a requestAnimationFrame loop,
checkboxes for the animate/progressive flags, a Mray/s HUD line) -- as a
browser tab served by a stdlib HTTP server:

  * a background thread runs the progressive RenderSession continuously,
    on the card by default (the render kernel; the scaled render kernel
    with --scaled);
  * `GET /frame.png` returns the latest accumulated frame, exact-sRGB
    encoded (the blit of PixelShader.hlsl:1-15);
  * `GET /stats` returns the HUD in the reference's format
    (TestWin.cpp:330) and the viewer's state;
  * `GET /set?animate=0|1&progressive=0|1` toggles the flags, and any
    toggle resets the accumulation (TestWin.cpp:424-431);
  * `GET /set?backend=<name>` switches the renderer between frames (key
    'g' in the page): the reference's GPU/CPU flip (TestWin.cpp:419-423),
    here "cuda" (the card's kernel) and "plain" (the plain PyTorch
    renderer on the same card), also under the JAX viewer's names
    "pallas" and "jnp".  Only the user switches; a switch resets the
    accumulation on the session's device;
  * animation time follows the wall clock scaled by 0.2, as the web
    frontend's (Cpp/Emscripten/main.cpp:57).

Usage:
    python -m toypathtracer_torch.serve [--port 8000] [--width 1280 ...]
        [--device cuda|cpu] [--scaled N]
        [--backend auto|pallas|jnp|sharded|parity]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from functools import partial
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from . import io as image_io
from .config import FLAG_ANIMATE, FLAG_PROGRESSIVE, RenderConfig
from .profiling import FrameTimer
from .render.frame import RenderSession, init_frame_state, sum_rays

_PAGE = """<!DOCTYPE html>
<html><head><title>toypathtracer_torch</title><style>
body {{ background: #222; color: #ddd; font: 13px monospace; margin: 1em; }}
img {{ image-rendering: pixelated; border: 1px solid #444; max-width: 100%; }}
label {{ margin-right: 1.5em; }}
#hud {{ margin: .6em 0; white-space: pre; }}
</style></head><body>
<div>
  <label><input type="checkbox" id="animate"> animate (a)</label>
  <label><input type="checkbox" id="progressive" checked> progressive (p)</label>
  <label id="backendlabel" style="display:none">
    backend (g): <span id="backend">?</span></label>
</div>
<div id="hud">starting...</div>
<img id="frame" width="{width}" alt="render">
<script>
const img = document.getElementById('frame');
const hud = document.getElementById('hud');
function setFlags() {{
  fetch('/set?animate=' + (animate.checked ? 1 : 0) +
        '&progressive=' + (progressive.checked ? 1 : 0));
}}
animate.onchange = setFlags; progressive.onchange = setFlags;
let backends = [], curBackend = '';
document.addEventListener('keydown', e => {{
  if (e.key === 'a') {{ animate.checked = !animate.checked; setFlags(); }}
  if (e.key === 'p') {{ progressive.checked = !progressive.checked; setFlags(); }}
  if (e.key === 'g' && backends.length > 1) {{
    const next = backends[(backends.indexOf(curBackend) + 1) % backends.length];
    fetch('/set?backend=' + next);
  }}
}});
function step() {{
  const next = new Image();
  next.onload = () => {{ img.src = next.src; requestAnimationFrame(step); }};
  next.onerror = () => setTimeout(step, 250);
  next.src = '/frame.png?t=' + Date.now();
}}
setInterval(() => fetch('/stats').then(r => r.json())
  .then(s => {{
    hud.textContent = s.hud;
    backends = s.backends; curBackend = s.backend;
    document.getElementById('backend').textContent = s.backend;
    document.getElementById('backendlabel').style.display =
      backends.length > 1 ? 'inline' : 'none';
  }}).catch(() => {{}}), 500);
step();
</script></body></html>
"""


# The JAX viewer's backend names and the port's: its Pallas kernel is the
# card's hand-written kernel here, its jnp renderer the plain PyTorch one.
BACKEND_ALIASES = {"pallas": "cuda", "jnp": "plain"}


class Viewer:
    """Owns the render loop and a thread-safe snapshot of (png, hud) for
    the HTTP handlers.  Flag and backend changes are applied between
    frames by the render thread (RenderSession is single-threaded).

    render_fns: {name: render_fn, None for the session's default: the
    card's kernel, or the plain version for device="cpu"}; more than one
    entry enables the runtime switch.  `render_fn` is the one-backend
    shorthand.  batch: frames a step while the view is static and
    progressive."""

    def __init__(self, scene, cfg: RenderConfig,
                 flags: int = FLAG_PROGRESSIVE, render_fn=None,
                 time_scale: float = 0.2, render_fns=None,
                 backend: str | None = None, batch: int = 1,
                 device="cuda"):
        if render_fns is None:
            render_fns = {"default": render_fn}
        self.render_fns = render_fns
        self.backend = backend if backend is not None \
            else next(iter(render_fns))
        if self.backend not in render_fns:
            raise ValueError(f"backend {self.backend!r} not in "
                             f"{sorted(render_fns)}")
        self.sess = RenderSession(scene, cfg, flags=flags,
                                  render_fn=render_fns[self.backend],
                                  device=device)
        self.cfg = cfg
        self.time_scale = time_scale
        self.batch = max(1, int(batch))
        self.timer = FrameTimer(window=10, title=(
            f"{self.sess.device.type.upper()} path tracer"))
        self._lock = threading.Lock()
        self._pending_flags: int | None = None
        self._pending_backend: str | None = None
        self._png = image_io.png_bytes(
            np.zeros((cfg.height, cfg.width, 3), np.float32))
        self._hud = "starting..."
        self._stop = threading.Event()
        self._t0 = time.perf_counter()
        self._thread: threading.Thread | None = None

    # -- control (any thread) ------------------------------------------
    def set_flags(self, animate: bool, progressive: bool) -> None:
        flags = (FLAG_ANIMATE if animate else 0) | \
                (FLAG_PROGRESSIVE if progressive else 0)
        with self._lock:
            self._pending_flags = flags

    def set_backend(self, name: str) -> bool:
        """Ask for a renderer switch (applied between frames; it resets
        the accumulation, TestWin.cpp:419-423).  The JAX viewer's names
        stand for the port's where the viewer has no backend of that name
        (BACKEND_ALIASES).  False for an unknown name."""
        if name not in self.render_fns:
            name = BACKEND_ALIASES.get(name, name)
        if name not in self.render_fns:
            return False
        with self._lock:
            self._pending_backend = name
        return True

    def snapshot(self):
        with self._lock:
            return self._png, self._hud

    @property
    def flags(self) -> int:
        with self._lock:
            pending = self._pending_flags
        return self.sess.flags if pending is None else pending

    def _new_timer(self):
        self.timer = FrameTimer(window=10, title=self.timer.title)

    # -- render loop (render thread) -----------------------------------
    def step_once(self) -> None:
        with self._lock:
            pending, self._pending_flags = self._pending_flags, None
            pending_b, self._pending_backend = self._pending_backend, None
        if pending is not None and pending != self.sess.flags:
            self.sess.set_flags(pending)  # resets the accumulation
            self._new_timer()
        if pending_b is not None and pending_b != self.backend:
            self.backend = pending_b
            self.sess.render_fn = self.render_fns[pending_b]
            self.sess.state = init_frame_state(self.cfg, self.sess.device)
            self._new_timer()
        t = (time.perf_counter() - self._t0) * self.time_scale
        # several frames a step only while accumulating a static view:
        # without progressive each frame overwrites the last, and an
        # animation needs each frame's own time
        flags_now = self.sess.flags
        n = self.batch if (flags_now & FLAG_PROGRESSIVE
                           and not flags_now & FLAG_ANIMATE) else 1
        t0 = time.perf_counter()
        img, raycount = self.sess.steps(time=t, n=n)
        img_h = img.detach().cpu().numpy()  # the host copy waits for it
        rays = sum_rays(raycount)
        self.timer.add(time.perf_counter() - t0, rays, count=n)
        png = image_io.png_bytes(img_h)
        with self._lock:
            self._png = png
            self._hud = self.timer.hud()

    def run(self) -> None:
        while not self._stop.is_set():
            self.step_once()

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)


def make_handler(viewer: Viewer):
    page = _PAGE.format(width=viewer.cfg.width).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path in ("/", "/index.html"):
                self._send(200, "text/html", page)
            elif url.path == "/frame.png":
                png, _ = viewer.snapshot()
                self._send(200, "image/png", png)
            elif url.path == "/stats":
                _, hud = viewer.snapshot()
                flags = viewer.flags
                body = json.dumps({
                    "hud": hud,
                    "mray_s": viewer.timer.mray_s(),
                    "frames": int(viewer.sess.state.frame),
                    "animate": bool(flags & FLAG_ANIMATE),
                    "progressive": bool(flags & FLAG_PROGRESSIVE),
                    "backend": viewer.backend,
                    "backends": sorted(viewer.render_fns),
                }).encode()
                self._send(200, "application/json", body)
            elif url.path == "/set":
                q = parse_qs(url.query)
                ok = True
                if "backend" in q:
                    ok = viewer.set_backend(q["backend"][0])
                if "animate" in q or "progressive" in q:
                    viewer.set_flags(
                        animate=q.get("animate", ["0"])[0] == "1",
                        progressive=q.get("progressive", ["1"])[0] == "1")
                body = b'{"ok": true}' if ok else b'{"ok": false}'
                self._send(200 if ok else 400, "application/json", body)
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def make_viewer(args) -> tuple:
    """The Viewer of serve's command line and a label of its backend."""
    import torch

    on_card = args.device == "cuda"
    # at most 64 frames a step: one step blocks the toggles and the HUD
    # for its whole duration
    batch = min(args.batch if args.batch > 0 else (8 if on_card else 1), 64)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, max_depth=args.max_depth,
                       pix_per_lane=args.ppl)
    flags = FLAG_PROGRESSIVE | (FLAG_ANIMATE if args.animate else 0)
    if args.backend in ("pallas", "jnp"):
        from .cli import pick_backend
        pick_backend(args.backend, args.device, bool(args.scaled))
    if args.scaled:
        from .scaled import make_scaled_scene, render_frame_scaled_plain
        if args.backend not in ("auto", "pallas", "jnp"):
            raise SystemExit("--scaled uses its own chunked renderer")
        scene = make_scaled_scene(n=args.scaled)
        plain = render_frame_scaled_plain
        label = f"scaled ({args.scaled} spheres)"
    else:
        from .render.wavefront import render_frame_plain
        from .scene import make_scene
        scene = make_scene(big=not args.small)
        plain = render_frame_plain
        label = ""
    if args.backend == "sharded":
        from .parallel.mesh import make_mesh, render_frame_sharded
        mesh = make_mesh(None if on_card else [torch.device("cpu")])
        fns, name = {"sharded": partial(render_frame_sharded, mesh=mesh)}, \
            f"sharded x{mesh.size}"
    elif args.backend == "parity":
        from .render.parity import render_frame_parity
        fns = {"parity": partial(render_frame_parity, device=args.device)}
        name = "parity"
    elif on_card:
        # the card's kernel and, on the 'g' key, the plain version;
        # --backend jnp starts on the plain version
        fns = {"cuda": None, "plain": plain}
        name = "plain" if args.backend == "jnp" else "cuda"
    else:
        fns, name = {"plain": None}, "plain"
    viewer = Viewer(scene, cfg, flags=flags, render_fns=fns,
                    backend=name if name in fns else next(iter(fns)),
                    batch=batch, device=args.device)
    return viewer, " ".join(x for x in (label, name) if x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="toypathtracer_torch.serve",
        description="live progressive viewer (browser frontend)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=10)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--scaled", type=int, default=0, metavar="N",
                    help="view the procedurally instanced N-sphere scene "
                         "(the scaled render kernel; 'g' flips to its "
                         "plain version)")
    ap.add_argument("--animate", action="store_true")
    ap.add_argument("--ppl", type=int, default=1, metavar="K",
                    help="the JAX viewer's TPU pixels per lane; never "
                         "changes the image, ignored by the card's kernel")
    ap.add_argument("--batch", type=int, default=0, metavar="N",
                    help="frames a step while the view is static (0: 8 on "
                         "the card, 1 on the CPU; at most 64); animation "
                         "always steps one frame")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "pallas", "jnp", "sharded", "parity"],
                    help="auto and pallas: the card's kernel, 'g' flipping "
                         "to the plain renderer (pallas has no CPU form); "
                         "jnp: the plain renderer on --device, 'g' "
                         "flipping to the card's kernel on a card; "
                         "sharded and parity stay fixed")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (default); cpu: the plain "
                         "PyTorch renderer on the CPU")
    args = ap.parse_args(argv)

    viewer, label = make_viewer(args)
    viewer.start()
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(viewer))
    print(f"serving backend={label} device={viewer.sess.device} at "
          f"http://{args.host}:{server.server_address[1]}/  (Ctrl-C stops)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        viewer.stop()
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
