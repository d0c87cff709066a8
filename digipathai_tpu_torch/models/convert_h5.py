"""Keras ``.h5`` checkpoint -> the port's variables tree, and back.

A numpy/h5py copy of ``digipathai_tpu/models/convert_h5.py``.  The
reference ships trained weights as Keras ``save_weights`` files per tissue
family.  The port's modules carry the Keras layer names ('/' -> '__'), so
conversion is a name-driven walk of the h5 groups with strict shape
checking.  The result is a nested numpy tree ``{'params': {layer: {leaf}},
'batch_stats': {layer: {leaf}}}``, which ``bridge.flax_to_torch`` loads
into a module (the parity tests bridge JAX's trees through the same
function).

==================  ===================  ===========================
h5 suffix           collection           leaf
==================  ===================  ===========================
kernel:0            params               kernel
depthwise_kernel:0  params               kernel (H, W, 1, C*M)
bias:0              params               bias
gamma:0             params               scale
beta:0              params               bias
moving_mean:0       batch_stats          mean
moving_variance:0   batch_stats          var
==================  ===================  ===========================

``h5py`` is imported only to read or write a file.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ["coverage_report", "keras_h5_to_flax", "write_keras_h5"]

_SUFFIX_MAP = {
    "kernel:0": ("params", "kernel"),
    "depthwise_kernel:0": ("params", "kernel"),
    "bias:0": ("params", "bias"),
    "gamma:0": ("params", "scale"),
    "beta:0": ("params", "bias"),
    "moving_mean:0": ("batch_stats", "mean"),
    "moving_variance:0": ("batch_stats", "var"),
}


def _h5_weight_items(h5) -> List[Tuple[str, str, np.ndarray]]:
    """(layer_name, weight_suffix, array) of every weight of a Keras
    weights h5."""
    root = h5["model_weights"] if "model_weights" in h5 else h5
    items = []
    layer_names = [
        n.decode() if isinstance(n, bytes) else n
        for n in root.attrs.get("layer_names", list(root.keys()))
    ]
    for ln in layer_names:
        if ln not in root:
            continue
        grp = root[ln]
        weight_names = [
            n.decode() if isinstance(n, bytes) else n
            for n in grp.attrs.get("weight_names", [])
        ]
        if not weight_names:  # fall back to walking datasets
            def visit(name, obj):
                if hasattr(obj, "shape"):
                    weight_names.append(name)
            grp.visititems(visit)
        for wn in weight_names:
            # Keras stores the dataset under the full weight path inside the
            # layer group; fall back to the group-relative path
            if wn in grp:
                arr = np.asarray(grp[wn])
            else:
                rel = wn[len(ln) + 1:] if wn.startswith(ln + "/") else wn
                arr = np.asarray(grp[rel])
            # weight path like 'conv1/conv/kernel:0' -> layer 'conv1/conv'
            parts = wn.split("/")
            suffix = parts[-1]
            layer = "/".join(parts[:-1]) if len(parts) > 1 else ln
            items.append((layer, suffix, arr))
    return items


_AUTO_CLASSES = ("conv2d", "batch_normalization")


def _auto_index(name: str, cls: str):
    if name == cls:
        return 0
    if name.startswith(cls + "_"):
        suffix = name[len(cls) + 1:]
        if suffix.isdigit():
            return int(suffix)
    return None


def _detect_auto_offsets(h5_layers, our_layers) -> Dict[str, int]:
    """Keras auto-names come from per-class counters that live as long as
    the process: a checkpoint saved after other models were built has every
    unnamed layer shifted (``conv2d_37`` where the module has ``conv2d``).
    The per-class offset is the difference of the smallest indices."""
    offsets = {}
    for cls in _AUTO_CLASSES:
        h5_idx = [i for n in h5_layers if (i := _auto_index(n, cls)) is not None]
        our_idx = [i for n in our_layers if (i := _auto_index(n, cls)) is not None]
        if h5_idx and our_idx and len(h5_idx) == len(our_idx):
            offsets[cls] = min(h5_idx) - min(our_idx)
        else:
            offsets[cls] = 0
    return offsets


def _unshift(name: str, offsets: Dict[str, int]) -> str:
    for cls, off in offsets.items():
        if off == 0:
            continue
        i = _auto_index(name, cls)
        if i is not None:
            j = i - off
            return cls if j == 0 else f"{cls}_{j}"
    return name


def keras_h5_to_flax(h5_path: str, variables: Dict[str, Any],
                     strict: bool = True) -> Dict[str, Any]:
    """Load a Keras ``.h5`` into a copy of the tree ``variables``.

    ``variables`` is the template (``bridge.torch_to_flax`` of a module):
    'params' and (optionally) 'batch_stats' collections keyed by the
    Keras-mirrored layer names.  Auto-named layers are aligned even when
    the checkpoint's name counters were offset.  A weight whose shape
    differs from the template's raises ``ValueError``; with ``strict`` so
    does any h5 weight the template has no place for.  Leaves the h5 does
    not name keep the template's values.
    """
    import h5py

    flat = {}
    for coll in variables:
        for lname, leaves in variables[coll].items():
            flat[(coll, lname)] = dict(leaves)

    with h5py.File(h5_path, "r") as f:
        items = _h5_weight_items(f)
    offsets = _detect_auto_offsets({layer for layer, _, _ in items},
                                   {ln for (_, ln) in flat})

    unmatched = []
    for layer, suffix, arr in items:
        if suffix not in _SUFFIX_MAP:
            unmatched.append((layer, suffix, "unknown suffix"))
            continue
        coll, leaf = _SUFFIX_MAP[suffix]
        key = (coll, _unshift(layer, offsets).replace("/", "__"))
        if key not in flat:
            unmatched.append((layer, suffix, "no such layer"))
            continue
        want = flat[key].get(leaf)
        if want is None:
            unmatched.append((layer, suffix, f"no leaf {leaf}"))
            continue
        if suffix == "depthwise_kernel:0":
            # Keras depthwise (H, W, C, M) -> grouped (H, W, 1, C*M): both
            # order the outputs c*M + m, so a C-order reshape maps them
            h, w, c, m = arr.shape
            arr = arr.reshape(h, w, 1, c * m)
        if tuple(want.shape) != tuple(arr.shape):
            raise ValueError(
                f"shape mismatch for {layer}/{suffix}: "
                f"h5 {arr.shape} vs template {tuple(want.shape)}")
        flat[key][leaf] = arr.astype(np.asarray(want).dtype)

    if strict and unmatched:
        raise ValueError(f"unmatched h5 weights: {unmatched[:10]}"
                         f"{'...' if len(unmatched) > 10 else ''}")

    out = {coll: {} for coll in variables}
    for (coll, lname), leaves in flat.items():
        out[coll][lname] = {k: np.asarray(v) for k, v in leaves.items()}
    return out


def coverage_report(h5_path: str, variables: Dict[str, Any]) -> Dict[str, list]:
    """Which layers of ``variables`` the checkpoint would (not) fill, with
    the same auto-name offset correction as ``keras_h5_to_flax``."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        raw = {layer for layer, _, _ in _h5_weight_items(f)}
    ours = set()
    for coll in variables:
        ours |= set(variables[coll].keys())
    offsets = _detect_auto_offsets(raw, ours)
    h5_layers = {_unshift(n, offsets).replace("/", "__") for n in raw}
    return {
        "matched": sorted(ours & h5_layers),
        "ours_only": sorted(ours - h5_layers),
        "h5_only": sorted(h5_layers - ours),
    }


def _h5_suffix(coll: str, lname: str, leaf: str, arr: np.ndarray):
    """(suffix, array) of one leaf in Keras's layout."""
    if coll == "batch_stats":
        return {"mean": "moving_mean:0", "var": "moving_variance:0"}[leaf], arr
    if leaf == "kernel":
        if arr.ndim == 4 and arr.shape[2] == 1 and "depthwise" in lname:
            # grouped (H, W, 1, C) -> Keras depthwise (H, W, C, 1)
            return "depthwise_kernel:0", np.transpose(arr, (0, 1, 3, 2))
        return "kernel:0", arr
    if leaf == "scale":
        return "gamma:0", arr
    if leaf == "bias":
        is_bn = ("bn" in lname.lower() or "normalization" in lname
                 or lname.endswith("_BN"))
        return ("beta:0" if is_bn else "bias:0"), arr
    raise ValueError(f"no Keras weight for {coll}/{lname}/{leaf}")


def write_keras_h5(path, variables: Dict[str, Any]) -> None:
    """Write a variables tree in Keras's ``save_weights`` layout (layer
    groups, full-path datasets, ``layer_names`` and ``weight_names``
    attributes, depthwise kernels as (H, W, C, 1)): the inverse of
    ``keras_h5_to_flax``."""
    import h5py

    layers = {}
    for coll in variables:
        for lname, leaves in variables[coll].items():
            kname = lname.replace("__", "/")
            for leaf, arr in leaves.items():
                layers.setdefault(kname, []).append(
                    _h5_suffix(coll, lname, leaf, np.asarray(arr)))
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            sorted({k.split("/")[0] for k in layers}), dtype="S")
        for kname, ws in layers.items():
            grp = f.require_group(kname.split("/")[0])
            names = [n.decode() if isinstance(n, bytes) else n
                     for n in grp.attrs.get("weight_names", [])]
            for suffix, arr in ws:
                wn = f"{kname}/{suffix}"
                grp.create_dataset(wn, data=arr)
                names.append(wn)
            grp.attrs["weight_names"] = np.array(names, dtype="S")
