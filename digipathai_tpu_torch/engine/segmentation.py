"""End-to-end WSI segmentation on PyTorch: the public ``getSegmentation``.

Port of the patch-mode path of ``digipathai_tpu/engine/segmentation.py``:
same signature, status strings, three pyramidal TIFFs and return value (the
0.3-thresholded mean map in (X, Y) orientation).  The flow: seeded or
loaded weights -> tissue-mask patch plan -> threaded uint8 loader -> one
device step per batch (normalize, model x TTA, stitch into a supertile
accumulator) -> background flush of each supertile's tissue bounding box
into host memmaps with host-computed counts -> chunked finalize ->
threshold and pyramid writes.

``crf=True`` refines the finalized mean map per supertile with the
mean-field CRF (``ops/crf.py``, whose bilateral message runs on the CUDA
kernel ``csrc/bilateral.cu``), staging each refined tile so a crashed run
replays it.  Options this slice does not run yet raise
``NotImplementedError`` naming their ROADMAP.md item.  The TPU-only layout
rewrites (``s2d_input``, ``s2d_decoder``, ``wpack``, ``decoder_halo_crop``,
``spatial_shard``) are exact, so they are accepted and the canonical form
runs.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..io.slide import Slide
from ..io.tiff_py import PyramidalTiffWriter
from ..models import registry
from ..models import weights as weights_mod
from ..ops import tta as tta_ops
from ..ops.stitch import add_counts_host, make_accumulator
from ..utils.profiling import StageTimer, maybe_profile
from .infer import build_step
from .loader import PatchLoader
from .planner import plan_patches

THRESHOLD = 0.3  # reference Segmentation.py:310

_ENSEMBLE = ("dense", "inception", "deeplabv3")


def _status_set(status_obj, **kw):
    if status_obj is None:
        return
    for k, v in kw.items():
        status_obj[k] = v


def _not_yet(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md {item})")


def _check_supported(quick, inference_mode, crf, quantized, fold_bn,
                     fused_stages, data_parallel):
    if not quick:
        _not_yet("quick=False (the 3-model ensemble)",
                 "§A item 9: Inception and DeepLab, with the ensemble")
    if inference_mode != "patch":
        if inference_mode == "tile" and crf:
            _not_yet("crf=True with inference_mode='tile' (the per-supertile "
                     "CRF)", "§A item 10: tile mode")
        if inference_mode == "tile":
            _not_yet("inference_mode='tile'", "§A item 10: tile mode")
        raise ValueError(f"inference_mode must be 'patch' or 'tile', "
                         f"got {inference_mode!r}")
    if quantized:
        _not_yet("quantized", "§A item 14: quantization")
    if fold_bn:
        _not_yet("fold_bn", "§A item 14: quantization and fold_bn")
    if fused_stages:
        _not_yet("fused_stages > 0",
                 "§B item 2: the fused_up_stage kernel")
    if (isinstance(data_parallel, int) and not isinstance(data_parallel, bool)
            and data_parallel > 1):
        _not_yet(f"data_parallel={data_parallel}", "§A item 12: multi-device")


def state_crf_applied(state_path, cfg_key) -> bool:
    """CRF refinement is in-place and non-idempotent; resumed runs must not
    re-refine already-refined maps."""
    try:
        state = json.loads(state_path.read_text())
        return state.get("config") == cfg_key and state.get("crf_applied", False)
    except (OSError, ValueError):
        return False


def mark_crf_applied(state_path, cfg_key):
    try:
        state = json.loads(state_path.read_text())
    except (OSError, ValueError):
        state = {"config": cfg_key}
    state["crf_applied"] = True
    tmp = state_path.with_suffix(".tmp")
    tmp.write_text(json.dumps(state))
    os.replace(tmp, state_path)


def _memmap_dir() -> Path:
    d = weights_mod.cache_dir() / "memmaps"
    d.mkdir(parents=True, exist_ok=True)
    return d


def getSegmentation(img_path,
                    patch_size: int = 256,
                    stride_size: int = 128,
                    batch_size: int = 32,
                    tta_list=None,
                    crf: bool = False,
                    probs_path: str = "../Results",
                    mask_path: str = "../Results",
                    uncertainty_path: str = "../Results",
                    status=None,
                    quick: bool = True,
                    mask_level: int = -1,
                    model: str = "dense",
                    mode: str = "colon",
                    *,
                    supertile: int = 4096,
                    num_workers: int = 8,
                    data_parallel: bool | int = True,
                    resume: bool = False,
                    inference_mode: str = "patch",
                    tile_local_aspp: bool = True,
                    tile_bbox_compute: bool = False,
                    spatial_shard="auto",
                    decoder_halo_crop: bool = False,
                    s2d_input: bool | int | str = "auto",
                    s2d_decoder: bool = False,
                    wpack: bool = False,
                    fused_stages: int = 0,
                    quantized=False,
                    mask_predictions: bool = False,
                    fold_bn: bool = False,
                    faithful_tta: bool = False,
                    allow_random_weights: bool = True,
                    save_float_probs: bool = False,
                    threshold: float = THRESHOLD,
                    compute_dtype=None,
                    crf_opts=None,
                    progress_cb=None,
                    device="cuda") -> np.ndarray:
    """Segment a whole-slide image; writes three pyramidal TIFFs.

    The reference's arguments, the JAX engine's keyword-only knobs, and
    ``device`` (a torch device; ``"cuda"`` needs a GPU and raises without
    one).  ``data_parallel=True`` means the one given device.  Returns the
    thresholded (0/255) mean map in (X, Y) orientation.
    """
    mode = mode.lower()
    if mode not in weights_mod.MODES:
        raise ValueError(
            "Unknown mode found, allowed fields are: ['colon', 'liver', 'breast']")
    _check_supported(quick, inference_mode, crf, quantized, fold_bn,
                     fused_stages, data_parallel)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested, but "
                           f"torch.cuda.is_available() is False")
    if compute_dtype is None:
        compute_dtype = torch.bfloat16
    elif isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)

    model_names = [model]
    tta_full = tta_ops.resolve_tta_list(tta_list)

    # --- weights ---------------------------------------------------------
    have_all = all(weights_mod.h5_path(mode, m).exists()
                   for m in model_names if m in _ENSEMBLE)
    _status_set(status, status=(
        "Found Trained Models, Skipping download" if have_all
        else "Downloading Trained Models"))
    _status_set(status, status="Loading Trained weights")

    bundles, variables_list = [], []
    for name in model_names:
        b = registry.build_model(name, dtype=compute_dtype)
        if name in _ENSEMBLE:
            v = weights_mod.load_variables(
                b, mode, name, patch_size, status=status,
                allow_random=allow_random_weights)
        else:
            v = b.init(patch_size)
        bundles.append(b)
        variables_list.append(v.to(device).eval())

    # --- plan + maps -----------------------------------------------------
    _status_set(status, status="Running segmentation")
    timer = StageTimer()
    slide = Slide(str(img_path))
    with timer.stage("plan"):
        plan = plan_patches(slide, patch=patch_size, stride=stride_size,
                            batch=batch_size, supertile=supertile,
                            mask_level=mask_level)
    X, Y = plan.slide_dims
    mdir = _memmap_dir()

    # --- restartable stitching state --------------------------------------
    # scratch/state keyed by basename + a hash of the absolute path; the
    # config key names the backend, so maps a JAX run left are not resumed
    abs_path = os.path.abspath(str(img_path))
    path_tag = hashlib.sha256(abs_path.encode()).hexdigest()[:10]
    stem = f"{Path(str(img_path)).stem}-{path_tag}"
    cfg_key = hashlib.sha256(repr((
        "torch", str(compute_dtype), abs_path, X, Y, patch_size, stride_size,
        batch_size, supertile, tuple(model_names), tuple(tta_full),
        faithful_tta, inference_mode, mask_predictions,
        bool(crf))).encode()).hexdigest()
    state_path = mdir / f"{stem}-stitch.json"
    completed: set = set()
    crf_tiles_done: set = set()
    mode_mm = "w+"
    finalized = False
    if resume and state_path.exists():
        try:
            state = json.loads(state_path.read_text())
            # a non-empty "inflight" means a crash mid-add: the maps may hold
            # partial, unrepeatable additions, so the state is tainted
            if state.get("config") == cfg_key and not state.get("inflight"):
                completed = set(state.get("completed", []))
                crf_tiles_done = set(state.get("crf_tiles", []))
                finalized = bool(state.get("finalized", False))
                mode_mm = "r+"
        except (ValueError, OSError):
            pass

    if mode_mm == "w+":  # fresh run: staged CRF tiles from older runs are stale
        for sp in mdir.glob(f"{stem}-crftile-*.npz"):
            sp.unlink()

    mean_map = np.memmap(mdir / f"{stem}-mean.dat", np.float32, mode_mm, shape=(Y, X))
    var_map = np.memmap(mdir / f"{stem}-var.dat", np.float32, mode_mm, shape=(Y, X))
    count_map = np.memmap(mdir / f"{stem}-count.dat", np.float32, mode_mm, shape=(Y, X))

    # guards the state file and the progress sets, which the flusher mutates
    state_lock = threading.Lock()

    def save_state(mark_finalized: bool = False, inflight=None):
        # "inflight" names a group whose memmap += writes are about to
        # start; the next save clears it (finalize is marked because
        # mean /= count is not idempotent)
        with state_lock:
            tmp = state_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(
                {"config": cfg_key, "completed": sorted(completed),
                 "crf_tiles": sorted(crf_tiles_done),
                 "finalized": mark_finalized or finalized,
                 "inflight": [inflight] if inflight is not None else []}))
            os.replace(tmp, state_path)

    # --- inference --------------------------------------------------------
    # counts are computed on the host (add_counts_host), so the accumulator
    # carries mean + var; with one prediction per patch the variance is
    # identically zero and its plane is not fetched
    n_preds = len(bundles) * len(tta_full)
    fetch_planes = 1 if n_preds == 1 else 2
    step = build_step(bundles, tta_full, patch_size, faithful_tta=faithful_tta,
                      compute_dtype=compute_dtype,
                      mask_predictions=mask_predictions, device=device)
    acc_side = supertile + patch_size
    total_batches = max(plan.total_batches, 1)
    done = sum(len(plan.groups[gi].coords) // batch_size
               for gi in completed if gi < len(plan.groups))

    def flush(acc, gi):
        g = plan.groups[gi]
        ox, oy = g.origin
        hx = min(acc_side, X - ox)
        hy = min(acc_side, Y - oy)
        # fetch only the tissue bounding box of the accumulator
        c = g.coords[g.valid]
        rx0 = int(c[:, 0].min() - ox)
        ry0 = int(c[:, 1].min() - oy)
        sx = int(c[:, 0].max() - ox) + patch_size - rx0
        sy = int(c[:, 1].max() - oy) + patch_size - ry0
        with timer.stage("flush"):
            host = (acc[:fetch_planes, rx0:rx0 + sx, ry0:ry0 + sy]
                    .transpose(1, 2).contiguous().cpu().numpy())
            save_state(inflight=gi)  # taint marker: += is not replayable
            # host block is (planes, sy, sx) at map offset (oy+ry0, ox+rx0)
            wy = min(sy, hy - ry0)
            wx = min(sx, hx - rx0)
            my, mx = oy + ry0, ox + rx0
            mean_map[my:my + wy, mx:mx + wx] += host[0, :wy, :wx]
            if fetch_planes > 1:
                var_map[my:my + wy, mx:mx + wx] += host[1, :wy, :wx]
            add_counts_host(count_map, g.coords, g.valid, patch_size)
        with state_lock:
            completed.add(gi)
        save_state()  # clears the inflight taint

    acc = None
    cur_group = -1
    with maybe_profile("segmentation"), ThreadPoolExecutor(1) as flusher:
        pending = []
        for batch in PatchLoader(slide, plan, num_workers=num_workers,
                                 skip_groups=completed):
            if batch.group_index != cur_group:
                if acc is not None:
                    # flush in the background while the next supertile runs
                    pending.append(flusher.submit(flush, acc, cur_group))
                    # each pending flush pins a device accumulator
                    while len(pending) > 2:
                        pending.pop(0).result()
                acc = make_accumulator(supertile, patch_size, planes=2,
                                       device=device)
                cur_group = batch.group_index
            with timer.stage("infer"):
                step(variables_list, acc, batch.patches, batch.offsets,
                     batch.valid)
            done += 1
            _status_set(status, progress=int(done * 100.0 / total_batches))
            if progress_cb is not None:
                progress_cb(done, total_batches)
        if acc is not None:
            pending.append(flusher.submit(flush, acc, cur_group))
        for fut in pending:
            fut.result()  # surface flush errors

    # --- finalize (chunked): mean /= count, var /= count^2 ---------------
    CHUNK = 4096
    if not finalized:
        with timer.stage("finalize"):
            for y0 in range(0, Y, CHUNK):
                y1 = min(y0 + CHUNK, Y)
                c = np.maximum(count_map[y0:y1], 1.0)
                mean_map[y0:y1] /= c
                var_map[y0:y1] /= c * c
            mean_map.flush()
            var_map.flush()
        finalized = True
        save_state(mark_finalized=True)

    # --- CRF post-pass ----------------------------------------------------
    # CRF rewrites mean_map in place per tile (non-idempotent), so each
    # refined tile is staged to disk (atomic rename) before the assignment
    # and unstaged after the progress marker is persisted; a crash anywhere
    # is recovered by replaying the staged assignment
    if crf and not state_crf_applied(state_path, cfg_key):
        from ..ops.crf import refine_slide_crf

        def crf_tile_done(ti, staged):
            with state_lock:
                crf_tiles_done.add(ti)
            save_state()
            staged.unlink(missing_ok=True)

        def crf_write(ti, box, refined):
            sp = mdir / f"{stem}-crftile-{ti}.npz"
            tmp = sp.with_name("tmp-" + sp.name)
            np.savez(tmp, box=np.asarray(box), block=refined)
            os.replace(tmp, sp)
            y0, y1, x0, x1 = box
            mean_map[y0:y1, x0:x1] = refined
            crf_tile_done(ti, sp)

        _status_set(status, status="Refining with CRF")
        with timer.stage("crf"):
            # replay tiles staged by a crashed previous run (assignment is
            # replayable; += is not, hence staging only exists for CRF)
            for sp in mdir.glob(f"{stem}-crftile-*.npz"):
                ti = int(sp.stem.rsplit("-", 1)[1])
                with np.load(sp) as z:
                    y0, y1, x0, x1 = (int(v) for v in z["box"])
                    mean_map[y0:y1, x0:x1] = z["block"]
                crf_tile_done(ti, sp)
            refine_slide_crf(slide, mean_map, supertile=supertile,
                             done=crf_tiles_done, on_tile=crf_write,
                             device=device, **(crf_opts or {}))
        mark_crf_applied(state_path, cfg_key)

    # --- write artifacts -------------------------------------------------
    def write_u8_pyramid(path, mm):
        """Native C++ streaming writer when built; python writer otherwise."""
        from ..io import backend as io_backend

        if io_backend.use_native():
            from ..io import native as io_native

            io_native.write_pyramidal_tiff(str(path), mm, compression="jpeg",
                                           quality=90)
            return
        with PyramidalTiffWriter(str(path), X, Y, channels=1, dtype=np.uint8,
                                 compression="jpeg", quality=90,
                                 scratch_dir=str(mdir)) as wr:
            wr.write_base(mm)

    def write_u8(path, transform):
        with timer.stage("write"):
            tmp = np.memmap(mdir / f"{stem}-u8.dat", np.uint8, "w+", shape=(Y, X))
            for y0 in range(0, Y, CHUNK):
                y1 = min(y0 + CHUNK, Y)
                tmp[y0:y1] = transform(y0, y1)
            tmp.flush()
            write_u8_pyramid(path, tmp)
            del tmp

    write_u8(probs_path, lambda a, b: np.clip(
        np.round(mean_map[a:b] * 255.0), 0, 255).astype(np.uint8))
    if save_float_probs:
        with PyramidalTiffWriter(str(probs_path) + ".f32.tiff", X, Y,
                                 channels=1, dtype=np.float32,
                                 compression="deflate",
                                 scratch_dir=str(mdir)) as wr:
            wr.write_base(mean_map)

    _status_set(status, progress=100)
    _status_set(status, status="Saving Prediction Mask...")
    mask_mm = np.memmap(mdir / f"{stem}-maskbin.dat", np.uint8, "w+", shape=(Y, X))
    with timer.stage("write"):
        for y0 in range(0, Y, CHUNK):
            y1 = min(y0 + CHUNK, Y)
            mask_mm[y0:y1] = np.where(
                mean_map[y0:y1] >= threshold, 255, 0).astype(np.uint8)
        mask_mm.flush()
        write_u8_pyramid(mask_path, mask_mm)

    _status_set(status, status="Saving Prediction Uncertanity...")
    write_u8(uncertainty_path, lambda a, b: np.clip(
        np.round(var_map[a:b] * 255.0), 0, 255).astype(np.uint8))
    _status_set(status, progress=0)

    timings = timer.summary()
    _status_set(status, timings=timings)
    print(f"[dpai-torch] {plan.total_patches} patches "
          f"({len(plan.groups)} supertiles, {device}): {timings}")

    slide.close()
    # the reference returns the thresholded map in (X, Y) orientation
    return mask_mm.T
