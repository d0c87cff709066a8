"""Trained weights for the port: fetch, verify, convert and cache.

A copy of ``digipathai_tpu/models/weights.py`` for torch modules.  The
trained checkpoints are the reference's per-tissue-family Keras ``.h5``
release assets.  ``load_variables`` takes, in order:

1. the port's converted cache ``<cache>/converted/<family>_<model>.torch.npz``,
   a flat ``np.savez`` of the module's state names (the JAX package's
   ``.flax.pkl`` pickle is never read or written);
2. the ``.h5`` (downloaded by ``ensure_h5`` unless ``DPAI_OFFLINE=1``),
   converted by ``convert_h5.keras_h5_to_flax`` after a coverage gate (a
   warning when any layer is unmatched, ``IOError`` above 5 %), then cached;
3. the seeded random init, with a warning and ``status["weights"] =
   "random"`` (or ``IOError`` when ``allow_random=False``).

``h5py`` is needed only to parse a ``.h5``.  ``download`` uses
``urllib.request``.

    python -m digipathai_tpu_torch.models.weights prefetch --mode breast
    python -m digipathai_tpu_torch.models.weights pin [--mode colon]
"""

from __future__ import annotations

import hashlib
import os
import warnings
from pathlib import Path
from typing import Optional

__all__ = ["MODES", "MODEL_KEYS", "cache_dir", "converted_path", "download",
           "ensure_h5", "h5_path", "h5_url", "load_variables",
           "pinned_sha256", "save_converted"]

MODES = {"colon": "digestpath", "liver": "paip", "breast": "camelyon"}
MODEL_KEYS = ("dense", "inception", "deeplabv3")

_RELEASE_BASE = "https://github.com/haranrk/DigiPathAI/releases/download/models"
_H5_NAME = {"dense": "densenet", "inception": "inception", "deeplabv3": "deeplabv3"}

# sha256 of the release .h5 assets, by file name.  None is recorded yet:
# ``python -m digipathai_tpu_torch.models.weights pin`` on a machine with
# network access downloads each asset, records its digest in
# <cache>/pins.json and prints the entries to paste here.  A digest that is
# present but wrong makes ``download`` fail.
_H5_SHA256: dict = {}


def pinned_sha256(filename: str):
    """Digest of a release asset: the built-in pin, else <cache>/pins.json."""
    if filename in _H5_SHA256:
        return _H5_SHA256[filename]
    import json

    try:
        pins = json.loads((cache_dir() / "pins.json").read_text())
        return pins.get(filename)
    except (OSError, ValueError):
        return None


def cache_dir() -> Path:
    root = os.environ.get("DPAI_CACHE", os.path.join(os.path.expanduser("~"), ".DigiPathAI"))
    return Path(root)


def h5_path(mode: str, model: str) -> Path:
    fam = MODES[mode]
    return cache_dir() / f"{fam}_models" / f"{fam}_{_H5_NAME[model]}.h5"


def h5_url(mode: str, model: str) -> str:
    fam = MODES[mode]
    return f"{_RELEASE_BASE}/{fam}_{_H5_NAME[model]}.h5"


def converted_path(mode: str, model: str) -> Path:
    return cache_dir() / "converted" / f"{MODES[mode]}_{model}.torch.npz"


def _chunks(url: str, timeout: int):
    """The response body of ``url`` in 1 MiB chunks."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        while chunk := r.read(1 << 20):
            yield chunk


def download(url: str, dst: Path, sha256: Optional[str] = None,
             retries: int = 3, timeout: int = 60) -> Path:
    """Atomic, retried download with optional checksum verification."""
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(dst.suffix + ".part")
    last_err: Optional[Exception] = None
    for _ in range(retries):
        try:
            hasher = hashlib.sha256()
            with open(tmp, "wb") as f:
                for chunk in _chunks(url, timeout):
                    f.write(chunk)
                    hasher.update(chunk)
            if sha256 and hasher.hexdigest() != sha256:
                raise IOError(f"checksum mismatch for {url}")
            os.replace(tmp, dst)
            return dst
        except Exception as e:  # noqa: BLE001 - retried, re-raised below
            last_err = e
            if tmp.exists():
                tmp.unlink()
    raise IOError(f"failed to download {url}: {last_err}")


def ensure_h5(mode: str, model: str, status=None) -> Optional[Path]:
    """The cached h5 path, downloaded if needed; None if unavailable."""
    p = h5_path(mode, model)
    if p.exists():
        return p
    if os.environ.get("DPAI_OFFLINE", "0") == "1":
        return None
    if status is not None:
        status["status"] = "Downloading Trained Models"
    try:
        return download(h5_url(mode, model), p, sha256=pinned_sha256(p.name))
    except IOError:
        return None


def save_converted(module, path: Path) -> Path:
    """Write ``module``'s state as a flat ``.npz`` of f32 arrays (atomic)."""
    import numpy as np

    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name("tmp-" + path.name)
    with open(tmp, "wb") as f:
        np.savez(f, **{k: v.detach().to("cpu").float().numpy()
                       for k, v in module.state_dict().items()})
    os.replace(tmp, path)
    return path


def _load_converted(module, path: Path):
    import numpy as np

    from .bridge import load_flat

    with np.load(path) as z:
        return load_flat({k: z[k] for k in z.files}, module)


def load_variables(bundle, mode: str, model: str, patch_size: int = 256,
                   status=None, allow_random: bool = True, seed: int = 0):
    """The module of ``bundle`` with weights for ``mode``/``model``:
    converted cache > h5 > seeded random init."""
    conv_path = converted_path(mode, model)
    if conv_path.exists():
        return _load_converted(bundle.module, conv_path).eval()

    h5 = ensure_h5(mode, model, status=status)
    module = bundle.init(patch_size, seed=seed)
    if h5 is not None:
        from .bridge import flax_to_torch, torch_to_flax
        from .convert_h5 import coverage_report, keras_h5_to_flax

        template = torch_to_flax(module)
        # a misaligned checkpoint must fail loudly, not cache half-random
        # weights that look like trained output
        rep = coverage_report(str(h5), template)
        n_ours = len(rep["matched"]) + len(rep["ours_only"])
        if rep["ours_only"]:
            warnings.warn(
                f"{mode}/{model}: {len(rep['ours_only'])}/{n_ours} layers "
                f"not present in the checkpoint (e.g. {rep['ours_only'][:3]})",
                stacklevel=2)
        if n_ours and len(rep["ours_only"]) > 0.05 * n_ours:
            raise IOError(
                f"checkpoint {h5} does not match the {model} architecture: "
                f"{len(rep['ours_only'])}/{n_ours} layers unmatched "
                f"(first: {rep['ours_only'][:5]})")
        flax_to_torch(keras_h5_to_flax(str(h5), template, strict=False),
                      module)
        save_converted(module, conv_path)
        return module.eval()

    if not allow_random:
        raise IOError(
            f"weights for {mode}/{model} unavailable and allow_random=False")
    return _random_fallback(module, mode, model, status)


def _random_fallback(module, mode, model, status):
    warnings.warn(
        f"trained weights for {mode}/{model} are unavailable "
        f"(offline or download failed) — falling back to RANDOM "
        f"initialization; segmentation output will be meaningless. "
        f"Pass allow_random_weights=False to fail instead.",
        stacklevel=3)
    if status is not None:
        status["weights"] = "random"
    return module


def main(argv=None) -> int:
    """Command line: prefetch and convert trained weights, or pin the
    release assets' digests."""
    import argparse

    from .registry import build_model

    ap = argparse.ArgumentParser(prog="digipathai_tpu_torch.models.weights")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pf = sub.add_parser("prefetch", help="download + convert checkpoints")
    pf.add_argument("--mode", choices=sorted(MODES), required=True)
    pf.add_argument("--models", nargs="+", default=list(MODEL_KEYS),
                    choices=list(MODEL_KEYS))
    pf.add_argument("--patch-size", type=int, default=256)
    pin = sub.add_parser(
        "pin", help="download assets, record sha256 pins to <cache>/pins.json")
    pin.add_argument("--mode", choices=sorted(MODES), action="append",
                     dest="modes", help="repeatable; default: all modes")
    args = ap.parse_args(argv)

    if args.cmd == "pin":
        import json

        pins_path = cache_dir() / "pins.json"
        try:
            pins = json.loads(pins_path.read_text())
        except (OSError, ValueError):
            pins = {}
        for mode in args.modes or sorted(MODES):
            for model in MODEL_KEYS:
                p = ensure_h5(mode, model)
                if p is None:
                    print(f"{mode}/{model}: download FAILED")
                    return 1
                digest = hashlib.sha256(p.read_bytes()).hexdigest()
                pins[p.name] = digest
                print(f'    "{p.name}": "{digest}",')
        pins_path.parent.mkdir(parents=True, exist_ok=True)
        pins_path.write_text(json.dumps(pins, indent=1, sort_keys=True))
        print(f"pins recorded to {pins_path}; paste the lines above into "
              f"_H5_SHA256 in {__file__}")
        return 0

    ok = True
    for model in args.models:
        try:
            b = build_model(model)
            load_variables(b, args.mode, model, args.patch_size,
                           allow_random=False)
            print(f"{args.mode}/{model}: ready "
                  f"({cache_dir() / 'converted'})")
        except IOError as e:
            ok = False
            print(f"{args.mode}/{model}: FAILED — {e}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
