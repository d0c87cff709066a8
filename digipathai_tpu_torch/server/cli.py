"""The port's server entry point: the ``digipathai-torch`` console script,
or ``python -m digipathai_tpu_torch.server.cli``.

Flag parity target: ``reference DigiPathAI/main_server.py:245-297`` —
``-s/--slide_dir, -B, -c, -d, -e, -f, -l, -p, -Q, -S, --viewer-only`` with
the same precedence: CLI > config file > environment > defaults.
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys

from .app import ServerConfig, create_app
from .wsgi_kit import serve


def build_config(argv=None) -> tuple:
    parser = argparse.ArgumentParser(
        prog="digipathai-torch",
        usage="%(prog)s [options] [slide-directory]")
    parser.add_argument("-s", "--slide_dir", default=None,
                        help="Directory containing the images (default: .)")
    parser.add_argument("-B", "--ignore-bounds", dest="limit_bounds",
                        action="store_false", default=None,
                        help="display entire scan area")
    parser.add_argument("-c", "--config", metavar="FILE",
                        help="config file (python, flask-style UPPERCASE names)")
    parser.add_argument("-d", "--debug", action="store_true", default=None,
                        help="run in debugging mode (insecure)")
    parser.add_argument("-e", "--overlap", metavar="PIXELS", type=int,
                        help="overlap of adjacent tiles [1]")
    parser.add_argument("-f", "--format", metavar="{jpeg|png}",
                        help="image format for tiles [jpeg]")
    parser.add_argument("-l", "--listen", metavar="ADDRESS", dest="host",
                        default="127.0.0.1", help="address to listen on")
    parser.add_argument("-p", "--port", metavar="PORT", type=int, default=8080,
                        help="port to listen on [8080]")
    parser.add_argument("-Q", "--quality", metavar="QUALITY", type=int,
                        help="JPEG compression quality [75]")
    parser.add_argument("-S", "--size", metavar="PIXELS", type=int,
                        help="tile size [254]")
    parser.add_argument("--viewer-only", action="store_true", default=None,
                        help="disable segmentation")
    # --- engine knobs (None = engine default); these make the measured
    # fast path (tile mode / ensemble / TTA / CRF) reachable from /segment
    parser.add_argument("--inference-mode", choices=("patch", "tile"),
                        default=None, help="engine inference mode")
    parser.add_argument("--ensemble", action="store_true", default=None,
                        help="run the 3-model ensemble (quick=False)")
    parser.add_argument("--model", default=None,
                        help="quick-mode model (dense|inception|deeplabv3)")
    parser.add_argument("--tta", default=None, metavar="LIST",
                        help="comma-separated TTA names, or 'all'")
    parser.add_argument("--crf", action="store_true", default=None,
                        help="enable dense-CRF refinement")
    parser.add_argument("--resume", action="store_true", default=None,
                        help="resume a crashed segmentation run")
    parser.add_argument("--data-parallel", default=None, metavar="N",
                        help="device data parallelism: true|false|<count>")
    parser.add_argument("--device", default="cuda",
                        help="torch device the engine runs on [cuda]")
    parser.add_argument("--engine-opt", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="extra getSegmentation kwarg (repeatable); "
                             "values parsed as python literals when possible")
    parser.add_argument("positional_dir", nargs="?", default=None)
    opts = parser.parse_args(argv)

    cfg = ServerConfig()
    # environment (reference: DEEPZOOM_MULTISERVER_SETTINGS pyfile)
    env_file = os.environ.get("DEEPZOOM_MULTISERVER_SETTINGS")
    layers = []
    if env_file:
        layers.append(runpy.run_path(env_file))
    if opts.config:
        layers.append(runpy.run_path(opts.config))
    layer_set_viewer_only = any("VIEWER_ONLY" in layer for layer in layers)
    mapping = {
        "SLIDE_DIR": "slide_dir",
        "SLIDE_CACHE_SIZE": "slide_cache_size",
        "DEEPZOOM_FORMAT": "deepzoom_format",
        "DEEPZOOM_TILE_SIZE": "deepzoom_tile_size",
        "DEEPZOOM_OVERLAP": "deepzoom_overlap",
        "DEEPZOOM_LIMIT_BOUNDS": "deepzoom_limit_bounds",
        "DEEPZOOM_TILE_QUALITY": "deepzoom_tile_quality",
        "VIEWER_ONLY": "viewer_only",
        "DEBUG": "debug",
        # engine knobs (config-file spellings)
        "ENGINE_INFERENCE_MODE": "inference_mode",
        "ENGINE_QUICK": "quick",
        "ENGINE_MODEL": "model",
        "ENGINE_TTA": "tta",
        "ENGINE_CRF": "crf",
        "ENGINE_RESUME": "resume",
        "ENGINE_DATA_PARALLEL": "data_parallel",
        "ENGINE_EXTRA": "engine_extra",
    }
    for layer in layers:
        for k, attr in mapping.items():
            if k in layer:
                setattr(cfg, attr, layer[k])
    # CLI overrides (only flags actually given)
    cli_map = {
        "slide_dir": "slide_dir", "limit_bounds": "deepzoom_limit_bounds",
        "debug": "debug", "overlap": "deepzoom_overlap",
        "format": "deepzoom_format", "quality": "deepzoom_tile_quality",
        "size": "deepzoom_tile_size",
    }
    for opt_name, attr in cli_map.items():
        v = getattr(opts, opt_name)
        if v is not None:
            setattr(cfg, attr, v)
    # engine-knob CLI overrides
    if opts.inference_mode is not None:
        cfg.inference_mode = opts.inference_mode
    if opts.ensemble:
        cfg.quick = False
    if opts.model is not None:
        cfg.model = opts.model
    if opts.tta is not None:
        cfg.tta = "all" if opts.tta == "all" else [
            t.strip() for t in opts.tta.split(",") if t.strip()]
    if opts.crf:
        cfg.crf = True
    if opts.resume:
        cfg.resume = True
    if opts.data_parallel is not None:
        v = opts.data_parallel.lower()
        if v in ("true", "yes", "on"):
            cfg.data_parallel = True
        elif v in ("false", "no", "off"):
            cfg.data_parallel = False
        else:
            try:
                cfg.data_parallel = int(opts.data_parallel)
            except ValueError:
                parser.error("--data-parallel takes true/false or a device "
                             f"count, got {opts.data_parallel!r}")
    for item in opts.engine_opt:
        if "=" not in item:
            parser.error(f"--engine-opt needs KEY=VALUE, got {item!r}")
        k, _, raw = item.partition("=")
        import ast

        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        cfg.engine_extra[k] = val
    cfg.engine_extra.setdefault("device", opts.device)
    if opts.positional_dir and opts.slide_dir is None:
        cfg.slide_dir = opts.positional_dir
    if cfg.slide_dir is None:
        cfg.slide_dir = "."
    # precedence: --viewer-only flag > config-file VIEWER_ONLY > default
    # False (the reference CLI enables segmentation unless flagged)
    if opts.viewer_only:
        cfg.viewer_only = True
    elif not layer_set_viewer_only:
        cfg.viewer_only = False
    return cfg, opts


def main(argv=None):
    cfg, opts = build_config(argv)
    app = create_app(cfg)
    httpd = serve(app, host=opts.host, port=opts.port)
    print(f"DigiPathAI-TPU serving {os.path.abspath(cfg.slide_dir)} "
          f"on http://{opts.host}:{httpd.server_port} "
          f"(viewer_only={cfg.viewer_only})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("\nshutting down")
        httpd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
