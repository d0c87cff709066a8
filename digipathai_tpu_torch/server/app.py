"""The viewer/segmentation HTTP application.

Route and behavior parity target: ``reference DigiPathAI/main_server.py``:

- ``GET /``                                   file browser
- ``GET /<path>``                             viewer page
- ``GET /<path>.dzi``                         Deep Zoom descriptor (XML)
- ``GET /<path>_files/<level>/<col>_<row>.<fmt>``  tiles (jpeg/png)
- ``POST /segment`` (form field ``tissuetype``)    start segmentation thread
- ``GET /check_segment_status``               status JSON (status/progress)
- ``GET /about``

Artifact naming contract kept: masks discovered as ``<base>-dgai-mask*``
(``main_server.py:109-123``), uncertainty as the last '-'-segment replaced
with ``uncertainty`` (``main_server.py:125-128``).
"""

from __future__ import annotations

import glob
import os
import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

from ..io.deepzoom import DeepZoomGenerator
from ..io.slide import Slide
from ..utils.status import SegmentationStatus
from .pages import page_about, page_files, page_viewer
from .wsgi_kit import App, Response, abort


#: the full dihedral TTA set (reference Segmentation.py:95-99)
FULL_TTA = ["FLIP_LEFT_RIGHT", "ROTATE_90", "ROTATE_180", "ROTATE_270"]


@dataclass
class ServerConfig:
    slide_dir: str = "."
    viewer_only: bool = True
    slide_cache_size: int = 10
    deepzoom_format: str = "jpeg"
    deepzoom_tile_size: int = 254
    deepzoom_overlap: int = 1
    deepzoom_limit_bounds: bool = True
    deepzoom_tile_quality: int = 75
    debug: bool = False
    extra: dict = field(default_factory=dict)
    # --- engine knobs forwarded to getSegmentation (None = engine default).
    # The reference hardcodes its /segment call (main_server.py:165-169);
    # these make the measured fast path (tile mode, ensemble, TTA, CRF)
    # reachable from the product surface.
    inference_mode: Optional[str] = None      # "patch" | "tile"
    quick: Optional[bool] = None              # False => 3-model ensemble
    model: Optional[str] = None               # quick-model choice
    tta: Optional[object] = None              # list of TTA names, or "all"
    crf: Optional[bool] = None
    resume: Optional[bool] = None
    data_parallel: Optional[object] = None    # bool | int device count
    engine_extra: dict = field(default_factory=dict)  # extra kwargs, verbatim

    def engine_kwargs(self) -> dict:
        """kwargs for ``segmentation_fn`` from the knobs set on this config."""
        kw = {}
        for attr, kwarg in (("inference_mode", "inference_mode"),
                            ("quick", "quick"), ("model", "model"),
                            ("crf", "crf"), ("resume", "resume"),
                            ("data_parallel", "data_parallel")):
            v = getattr(self, attr)
            if v is not None:
                kw[kwarg] = v
        if self.tta is not None:
            # accept "all", a comma-joined string from a config file
            # (TTA = "FLIP_LEFT_RIGHT,ROTATE_90" — common aliases like
            # "hflip"/"rot90" are normalized by resolve_tta_list), or any
            # iterable of names — a bare string must not be iterated
            # char-by-char
            if self.tta == "all":
                kw["tta_list"] = list(FULL_TTA)
            elif isinstance(self.tta, str):
                kw["tta_list"] = [t.strip() for t in self.tta.split(",")
                                  if t.strip()]
            else:
                kw["tta_list"] = list(self.tta)
        kw.update(self.engine_extra)
        return kw


class SlideCache:
    """LRU of (Slide, DeepZoomGenerator) pairs (main_server.py:39-68)."""

    def __init__(self, cache_size: int, dz_opts: dict):
        self.cache_size = cache_size
        self.dz_opts = dz_opts
        self._lock = threading.Lock()
        self._cache: "OrderedDict[str, DeepZoomGenerator]" = OrderedDict()

    def get(self, path: str) -> DeepZoomGenerator:
        with self._lock:
            if path in self._cache:
                dz = self._cache.pop(path)
                self._cache[path] = dz
                return dz
        slide = Slide(path)
        dz = DeepZoomGenerator(slide, **self.dz_opts)
        with self._lock:
            if path in self._cache:
                # another thread won the race; drop our duplicate handle
                slide.close()
                return self._cache[path]
            if len(self._cache) >= self.cache_size:
                # evict without closing: concurrent requests may still be
                # reading tiles; the reader's finalizer closes the fd once
                # the last reference dies
                self._cache.popitem(last=False)
            self._cache[path] = dz
        return dz


def get_mask_path_basename(path: str) -> str:
    return os.path.splitext(path)[0] + "-dgai-mask"


def get_mask_path(path: str):
    """Path of the associated mask, or False (main_server.py:112-123)."""
    hits = glob.glob(glob.escape(get_mask_path_basename(path)) + "*")
    if not hits:
        return False
    if len(hits) > 1:
        raise ValueError("Duplicate masks found")
    return hits[0]


def get_uncertainty_path(path: str) -> str:
    """Reference-parity helper (main_server.py:125-128): replaces the last
    '-'-segment with 'uncertainty'. Note it mangles paths without a '-dgai'
    suffix, exactly like the reference; the viewer derives overlay URLs with
    the saner '-dgai-uncertainty' convention instead (slide_page)."""
    return "-".join(path.split("-")[:-1] + ["uncertainty"]) + "." + path.split(".")[-1]


def list_slides(basedir: str, relpath: str = "", depth: int = 0):
    """Recursive slide listing (reference _Directory, main_server.py:70-89)."""
    entries = []
    try:
        names = sorted(os.listdir(os.path.join(basedir, relpath)))
    except OSError:
        return entries
    for name in names:
        cur_rel = os.path.join(relpath, name)
        cur = os.path.join(basedir, cur_rel)
        if os.path.isdir(cur):
            sub = list_slides(basedir, cur_rel, depth + 1)
            if sub:
                entries.append({"name": name, "is_dir": True, "depth": depth})
                entries.extend(sub)
        elif Slide.detect_format(cur):
            base = os.path.basename(cur)
            if "dgai-mask" in base or "dgai-uncertainty" in base:
                continue
            entries.append({
                "name": name, "url_path": cur_rel.replace(os.sep, "/"),
                "mask_present": bool(get_mask_path(cur)), "depth": depth,
            })
    return entries


def get_slide_properties(path: str) -> dict:
    with Slide(path) as s:
        w, h = s.dimensions
    props = {"Dimensions": f"{h} x {w} pixel"}
    area = w * h
    if area >= 1e6:
        props["Area"] = f"{area // int(1e6)} million pixels"
    elif area >= 1e3:
        props["Area"] = f"{area // int(1e3)} thousand pixels"
    else:
        props["Area"] = f"{area} pixels"
    return props


def create_app(config: Optional[ServerConfig] = None,
               segmentation_fn=None) -> App:
    """Build the WSGI app. ``segmentation_fn`` defaults to the real engine
    (injected for tests)."""
    cfg = config or ServerConfig()
    app = App()
    basedir = os.path.abspath(cfg.slide_dir)
    cache = SlideCache(cfg.slide_cache_size, {
        "tile_size": cfg.deepzoom_tile_size,
        "overlap": cfg.deepzoom_overlap,
        "limit_bounds": cfg.deepzoom_limit_bounds,
    })
    status = SegmentationStatus()
    app.dpai = {"config": cfg, "status": status, "basedir": basedir}  # type: ignore[attr-defined]
    static_dir = os.path.join(os.path.dirname(__file__), "static")

    def _resolve(path: str) -> str:
        full = os.path.abspath(os.path.join(basedir, path))
        if not full.startswith(basedir + os.sep) and full != basedir:
            abort(404, "directory traversal")
        if not os.path.exists(full):
            abort(404, path)
        return full

    def _get_dz(path: str) -> DeepZoomGenerator:
        try:
            return cache.get(_resolve(path))
        except (ValueError, OSError, struct.error):
            # the readers' full corrupt-file contract (io/slide.py:380,
            # tests/test_corrupt_inputs.py): a truncated slide raises
            # OSError and must 404 like any other unreadable file, not 500
            abort(404, f"unreadable slide: {path}")

    @app.route(r"/", methods=("GET",))
    def index(req):
        return Response(page_files(list_slides(basedir)))

    @app.route(r"/about", methods=("GET",))
    def about(req):
        return Response(page_about())

    @app.route(r"/static/(?P<rel>[\w./-]+)", methods=("GET",))
    def static(req, rel):
        full = os.path.abspath(os.path.join(static_dir, rel))
        if not full.startswith(static_dir + os.sep) or not os.path.isfile(full):
            abort(404, rel)
        ctype = ("application/javascript" if full.endswith(".js")
                 else "text/css" if full.endswith(".css") else "application/octet-stream")
        with open(full, "rb") as f:
            return Response(f.read(), content_type=ctype)

    @app.route(r"/check_segment_status", methods=("GET",))
    def check_segment_status(req):
        return Response.json(status.snapshot())

    _BOOLS = {"1": True, "true": True, "yes": True,
              "0": False, "false": False, "no": False}

    def _request_overrides(req) -> dict:
        """Optional per-request engine knobs on ``POST /segment`` (exceeds
        the reference's hardcoded call, ``main_server.py:165-169``): one
        server serves both quick-look and full-quality requests.  Strictly
        validated — a bad value 400s before any worker thread starts, so a
        typo can't silently burn a 10-minute ensemble run."""
        kw = {}
        for knob in ("quick", "crf"):
            v = req.form.get(knob)
            if v is not None:
                if v.lower() not in _BOOLS:
                    abort(400, f"{knob} must be a boolean "
                               f"(one of {sorted(_BOOLS)}), got {v!r}")
                kw[knob] = _BOOLS[v.lower()]
        v = req.form.get("inference_mode")
        if v is not None:
            if v not in ("patch", "tile"):
                abort(400, f"inference_mode must be 'patch' or 'tile', "
                           f"got {v!r}")
            kw["inference_mode"] = v
        v = req.form.get("model")
        if v is not None:
            from ..models.registry import resolve_model_name
            try:
                resolve_model_name(v)
            except ValueError as e:
                abort(400, str(e))
            kw["model"] = v
        v = req.form.get("tta")
        if v is not None:
            names = (list(FULL_TTA) if v == "all"
                     else [t.strip() for t in v.split(",") if t.strip()])
            from ..ops.tta import resolve_tta_list
            try:
                resolve_tta_list(names)
            except (ValueError, KeyError) as e:
                abort(400, f"bad tta list {v!r}: {e}")
            kw["tta_list"] = names
        return kw

    @app.route(r"/segment", methods=("POST",))
    def segment(req):
        overrides = _request_overrides(req)  # validate BEFORE mutating state
        status["tissuetype"] = req.form.get("tissuetype", "Colon")
        if cfg.viewer_only:
            status["status"] = True  # reference: status <- VIEWER_ONLY flag
        else:
            fn = segmentation_fn or _default_segmentation_fn()
            t = threading.Thread(
                target=_run_segmentation,
                args=(status, fn, {**cfg.engine_kwargs(), **overrides}),
                daemon=True)
            t.start()
        return Response.json(status.snapshot())

    @app.route(r"/(?P<path>.+)\.dzi", methods=("GET",))
    def dzi(req, path):
        dz = _get_dz(path)
        return Response(dz.get_dzi(cfg.deepzoom_format),
                        content_type="application/xml")

    @app.route(r"/(?P<path>.+)_files/(?P<level>\d+)/(?P<col>\d+)_(?P<row>\d+)\.(?P<fmt>\w+)",
               methods=("GET",))
    def tile(req, path, level, col, row, fmt):
        fmt = fmt.lower()
        if fmt not in ("jpeg", "png"):
            abort(404, f"unsupported tile format {fmt}")
        dz = _get_dz(path)
        try:
            data = dz.tile_bytes(int(level), (int(col), int(row)), fmt,
                                 cfg.deepzoom_tile_quality)
        except ValueError:
            abort(404, "invalid level or coordinates")
        return Response(data, content_type=f"image/{fmt}")

    @app.route(r"/(?P<path>.+)", methods=("GET",))
    def slide_page(req, path):
        full = _resolve(path)
        dz = _get_dz(path)
        slide_url = "/" + path
        mask_fs = get_mask_path(full)
        mask_url = uncertainty_url = None
        if mask_fs:
            root, ext = os.path.splitext(slide_url)
            mask_url = root + "-dgai-mask" + ext
            uncertainty_url = root + "-dgai-uncertainty" + ext
            # existence checks must not abort the page (a mask saved with a
            # different extension just hides the overlay)
            if not os.path.exists(os.path.join(basedir, mask_url.lstrip("/"))):
                mask_url = None
            unc_fs = os.path.join(basedir, uncertainty_url.lstrip("/"))
            if not os.path.exists(unc_fs):
                uncertainty_url = None
        status["slide_path"] = full
        return Response(page_viewer(
            slide_url, mask_url, uncertainty_url, cfg.viewer_only,
            get_slide_properties(full), os.path.basename(full), dz.mpp))

    return app


def _default_segmentation_fn():
    from ..engine.segmentation import getSegmentation

    return getSegmentation


def _run_segmentation(status, segmentation_fn, engine_kwargs=None):
    """Worker (reference run_segmentation, main_server.py:161-172) with
    error propagation instead of a stuck 'Running' status.

    ``engine_kwargs`` (from ``ServerConfig.engine_kwargs()``) is forwarded
    verbatim so configured deployments reach tile mode / ensemble / TTA /
    CRF — only passed when non-empty, so injected test doubles keep their
    reference-shaped signature."""
    status["status"] = "Running"
    slide_path = status["slide_path"]
    root, ext = os.path.splitext(slide_path)
    mask_path = get_mask_path(slide_path) or (root + "-dgai-mask" + ext)
    try:
        segmentation_fn(
            img_path=slide_path,
            mask_path=mask_path,
            probs_path=root + "-dgai-probs" + ext,
            uncertainty_path=root + "-dgai-uncertainty" + ext,
            status=status,
            mode=str(status.get("tissuetype", "Colon")).lower(),
            **(engine_kwargs or {}),
        )
        status["status"] = "Done"
    except Exception as e:  # noqa: BLE001 — surface to the polling client
        import traceback

        traceback.print_exc()
        status["error"] = f"{type(e).__name__}: {e}"
        status["status"] = "Error"
