"""End-to-end WSI segmentation on PyTorch: the public ``getSegmentation``.

Port of ``digipathai_tpu/engine/segmentation.py``: same signature, status
strings, three pyramidal TIFFs and return value (the 0.3-thresholded mean
map in (X, Y) orientation).  The flow: seeded or loaded weights ->
tissue-mask patch plan -> inference -> chunked finalize -> threshold and
pyramid writes.  Inference runs in one of two modes:

- patch mode: a threaded uint8 loader, one device step per batch
  (normalize, model x TTA, stitch into a supertile accumulator) and a
  background flush of each supertile's tissue bounding box into host
  memmaps with host-computed counts.  On D devices it runs grid-dp
  (``parallel/inference.py``): each global batch of ``D * batch_size``
  patches is split into D shards, each stitched on its own device into
  its own accumulator, and a flush sums the D accumulators;
- tile mode (``engine/tile_infer.py``): one fully convolutional forward
  per tissue supertile plus a ``patch_size // 2`` halo, written straight
  into the maps; on D devices the supertiles are dealt round-robin, each
  computed (and CRF-refined) on its device, or each supertile is computed
  by all D devices at once (``spatial_shard``, below).  ``fused_stages``
  runs the U-Net decoders' last stages (DenseNet's and Inception's) on the
  ``fused_up_stage`` kernel there.
  ``tile_local_aspp`` (default on) is not a layout rewrite: when
  ``supertile % patch_size == 0`` DeepLab is rebuilt with
  ``aspp_pool_window=patch_size`` and the same weights, so its ASPP pools
  patch-sized windows of the tile instead of the whole tile, as JAX does.

``quick=True`` runs ``model`` alone; ``quick=False`` the reference's
3-model ensemble (dense, inception, deeplabv3), each with every TTA chain.
``crf=True`` refines the mean map per supertile with the mean-field CRF
(``ops/crf.py``, whose bilateral message runs on the CUDA kernel
``csrc/bilateral.cu``): in tile mode each supertile at its flush, in patch
mode in a post-pass after finalize.  Each refined tile is staged so a
crashed run replays it.

Weights load as the JAX engine's do (``models/weights.py``): the port's
converted ``.npz`` cache, else the trained ``.h5`` (downloaded unless
``DPAI_OFFLINE=1``), else the seeded random init with
``status["weights"] = "random"``.  ``fold_bn=True`` folds each conv -> BN
pair into the conv once the weights are loaded (``models/fold_bn.py``).
``quantized`` takes every form the JAX engine takes: True or
``"dynamic"``, ``"calib"``, ``"static"``, a per-model spec such as
``"deeplabv3:static,dense:off"`` or a dict (``_resolve_quant``); it runs
each model's eligible convs in int8 (``models/quant.py``).  A static model
is calibrated first on up to 8 tissue patches of the first planned
supertile.  The resume state's config key covers the quantization of the
models that run (``_quant_tag``), so a changed knob starts anew.

Devices: ``device`` is a torch device or a list of them
(``parallel/inference.py::make_dp_devices``), and ``data_parallel`` picks
how many of them run, as in JAX: True all of them (``"cuda"`` without an
index names every visible card), an integer n at most the first n, False
the first one.  A list may repeat a device; each entry is then a shard of
its own.  One model replica is built per further shard once the weights
are loaded, folded, quantized and calibrated (on the first device).  The
resume key holds the global batch, so a dp run and a serial run never
resume each other.  In tile mode ``spatial_shard`` picks the scheme by
JAX's rule (``engine/tile_infer.py::run_tile_inference``): ``"auto"`` (the
default) computes each supertile on all devices at once, its rows split
over them (``build_tile_step_sp``), when the slide has fewer tissue
supertiles left than devices and ``(supertile + patch_size) %
n_devices == 0``, and deals supertiles round-robin otherwise; True always
shards (``ValueError`` where it cannot), False never.  The TPU-only
layout rewrites (``s2d_input``, ``s2d_decoder``, ``wpack``,
``decoder_halo_crop``) are exact, so they are accepted and the canonical
form runs.  The JAX package's binary head
(``models/heads.py::binary_p1``) is a TPU layout rewrite that its engine
never calls; it is not ported.
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
from ..ops.stitch import add_counts_host
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


def _check_supported(inference_mode):
    if inference_mode not in ("patch", "tile"):
        raise ValueError(f"inference_mode must be 'patch' or 'tile', "
                         f"got {inference_mode!r}")


def _n_devices(data_parallel, available: int) -> int:
    """How many devices run, as the JAX engine resolves it: True (or any
    truthy non-integer) all ``available``, an integer n at most n, False
    or 0 one."""
    if not data_parallel:
        return 1
    if isinstance(data_parallel, int) and data_parallel is not True:
        return max(1, min(available, data_parallel))
    return available


def _parse_quant_spec(spec):
    """A per-model quantization spec string as a dict.

    ``"deeplabv3:static"`` -> ``{"deeplabv3": "static"}``;
    ``"deeplabv3:static,dense:dynamic"`` maps each named model to a mode
    (``static`` / ``calib`` / ``dynamic``/``true`` -> True / ``off`` ->
    False).  A string without a colon is a uniform mode and is returned as
    it is (``"static"`` applies to every model).
    """
    if ":" not in spec:
        return spec
    out = {}
    for part in spec.split(","):
        name, _, mode = part.partition(":")
        name = registry.resolve_model_name(name.strip())
        mode = mode.strip().lower()
        if mode in ("static", "calib"):
            out[name] = mode
        elif mode in ("1", "true", "dynamic"):
            out[name] = True
        elif mode in ("0", "false", "off", ""):
            out[name] = False
        else:
            raise ValueError(f"unknown quantization mode {mode!r} for "
                             f"{name!r} (expected static/calib/dynamic/off)")
    return out


def _resolve_quant(quantized, key: str):
    """The quantization mode of canonical model ``key``: ``quantized`` is
    False/True/"calib"/"static" (uniform), a spec string
    (``_parse_quant_spec``) or a dict of canonical model keys to modes."""
    if isinstance(quantized, str):
        quantized = _parse_quant_spec(quantized)
    if isinstance(quantized, dict):
        return quantized.get(key, False)
    return quantized


def _quant_tag(quantized, keys=None):
    """The resume key's tag for the quantized knob, the same for any dict
    order or spec spelling.  With ``keys`` (the canonical keys of the
    models that run) it covers only their effective modes: a spec naming
    an absent model leaves the maps as they are, and a uniform mode tags
    like the same per-model dict."""
    if keys is not None:
        return tuple(sorted(
            (k, q) for k in keys
            if (q := _resolve_quant(quantized, k))))
    if isinstance(quantized, str):
        quantized = _parse_quant_spec(quantized)
    if isinstance(quantized, dict):
        return tuple(sorted((k, v) for k, v in quantized.items() if v))
    return quantized


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


@maybe_profile("segmentation")  # the whole call, where DPAI_PROFILE_DIR asks
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
    ``device``: a torch device or a sequence of them.  ``"cuda"`` without
    an index names every visible card, ``"cuda:1"`` or ``"cpu"`` one
    device, a list exactly its entries (a repeated entry is one more
    shard on that device); a CUDA device raises without a GPU.
    ``data_parallel`` runs on all of the named devices (True, as JAX's
    every local device), the first n (an integer) or the first one
    (False).  Returns the thresholded (0/255) mean map in (X, Y)
    orientation.  ``status["timings"]`` gets the call's span seconds and
    counters (``utils/profiling.py::StageTimer.summary``).
    """
    from ..parallel import inference as par

    timer = StageTimer()

    mode = mode.lower()
    if mode not in weights_mod.MODES:
        raise ValueError(
            "Unknown mode found, allowed fields are: ['colon', 'liver', 'breast']")
    _check_supported(inference_mode)
    devices = par.make_dp_devices(None, device)
    n_dev = _n_devices(data_parallel, len(devices))
    devices = devices[:n_dev]
    device = devices[0]  # weights, calibration and the CRF post-pass
    global_batch = batch_size * n_dev
    if compute_dtype is None:
        compute_dtype = torch.bfloat16
    elif isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)

    # quick=True -> one model; else the 3-model ensemble
    # (reference Segmentation.py:288-300)
    model_names = list(_ENSEMBLE) if not quick else [model]
    tta_full = tta_ops.resolve_tta_list(tta_list)

    # --- weights ---------------------------------------------------------
    have_all = all(weights_mod.h5_path(mode, m).exists()
                   for m in model_names if m in _ENSEMBLE)
    _status_set(status, status=(
        "Found Trained Models, Skipping download" if have_all
        else "Downloading Trained Models"))
    _status_set(status, status="Loading Trained weights")

    bundles, variables_list = [], []
    model_kws = {}  # canonical name -> the build's kwargs
    for name in model_names:
        key = registry.resolve_model_name(name)
        kw = {}
        if key in ("dense", "inception"):
            # the U-Net decoder's last stages on the fused_up_stage kernel
            # (taken at N == 1 only, i.e. tile mode); s2d_decoder turns it
            # off, as in JAX
            kw = {"fused_stages": fused_stages, "s2d_decoder": s2d_decoder}
        q = _resolve_quant(quantized, key)
        if q:
            # True (dynamic), "calib" or "static", as given
            kw["quantized"] = q
        with timer.stage("build"):
            b = registry.build_model(name, dtype=compute_dtype, **kw)
        model_kws[b.name] = kw
        with timer.stage("load"):
            if name in _ENSEMBLE:
                v = weights_mod.load_variables(
                    b, mode, name, patch_size, status=status,
                    allow_random=allow_random_weights)
            else:
                v = b.init(patch_size)
        with timer.stage("to_device"):
            if fold_bn:
                from ..models.fold_bn import fold_module

                fold_module(v)
            v = v.to(device).eval()
        bundles.append(b)
        variables_list.append(v)

    # --- plan + maps -----------------------------------------------------
    _status_set(status, status="Running segmentation")
    timer.start()  # "total" leaves the weights out
    with timer.stage("open"):
        slide = Slide(str(img_path))
    with timer.stage("plan"):
        plan = plan_patches(slide, patch=patch_size, stride=stride_size,
                            batch=global_batch, supertile=supertile,
                            mask_level=mask_level)
    X, Y = plan.slide_dims
    mdir = _memmap_dir()

    def wrote(path):
        timer.count("bytes_written", os.path.getsize(path))

    static_idx = [i for i, b in enumerate(bundles)
                  if model_kws[b.name].get("quantized") == "static"]
    if static_idx and plan.groups:
        # the static int8 ranges, from up to 8 tissue patches of the first
        # planned supertile in the engine's (x, y, c) patch orientation;
        # the ranges are per-layer scalars, so patch-sized forwards
        # calibrate tile mode's forwards as well
        from ..models.quant import calibrate
        from ..ops.color import normalize_patches

        g0 = plan.groups[0]
        sel = g0.coords[np.asarray(g0.valid, bool)][:8]
        if len(sel) == 0:
            sel = g0.coords[:1]
        sample = np.stack([
            np.asarray(slide.read_region((int(x), int(y)), 0,
                                         (patch_size, patch_size)))[..., :3]
            .transpose(1, 0, 2)
            for x, y in sel]).astype(np.uint8)
        xn = normalize_patches(torch.from_numpy(sample).to(device),
                               dtype=compute_dtype)
        for i in static_idx:
            calibrate(variables_list[i], [xn])

    # --- restartable stitching state --------------------------------------
    # scratch/state keyed by basename + a hash of the absolute path; the
    # config key names the backend, so maps a JAX run left are not resumed,
    # holds the global batch, so dp and serial runs do not resume each
    # other, and covers crf and quantized, which change what the maps hold
    abs_path = os.path.abspath(str(img_path))
    path_tag = hashlib.sha256(abs_path.encode()).hexdigest()[:10]
    stem = f"{Path(str(img_path)).stem}-{path_tag}"
    cfg_key = hashlib.sha256(repr((
        "torch", str(compute_dtype), abs_path, X, Y, patch_size, stride_size,
        global_batch, supertile, tuple(model_names), tuple(tta_full),
        faithful_tta, inference_mode, mask_predictions, bool(crf),
        _quant_tag(quantized, keys=model_kws))).encode()).hexdigest()
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

    with timer.stage("maps"):
        if mode_mm == "w+":
            # fresh run: staged CRF tiles from older runs are stale
            for sp in mdir.glob(f"{stem}-crftile-*.npz"):
                sp.unlink()
        mean_map, var_map, count_map = (
            np.memmap(mdir / f"{stem}-{k}.dat", np.float32, mode_mm,
                      shape=(Y, X)) for k in ("mean", "var", "count"))
        if mode_mm == "w+":
            for m in (mean_map, var_map, count_map):
                wrote(m.filename)

    # guards the state file and the progress sets, which the flushers
    # mutate; re-entrant because tile mode's flush saves state under it
    state_lock = threading.RLock()

    def save_state(mark_finalized: bool = False, inflight=None):
        # "inflight" names a group whose memmap += writes are about to
        # start; the next save clears it (finalize is marked because
        # mean /= count is not idempotent)
        with state_lock:
            tmp = state_path.with_suffix(".tmp")
            text = json.dumps(
                {"config": cfg_key, "completed": sorted(completed),
                 "crf_tiles": sorted(crf_tiles_done),
                 "finalized": mark_finalized or finalized,
                 "inflight": [inflight] if inflight is not None else []})
            tmp.write_text(text)
            os.replace(tmp, state_path)
        timer.count("bytes_written", len(text))

    # --- CRF staging, shared by tile mode's per-supertile CRF and the
    # post-pass: CRF rewrites mean_map in place per tile (non-idempotent),
    # so each refined tile is staged to disk (atomic rename) before the
    # assignment and unstaged after the progress marker is persisted; a
    # crash anywhere is recovered by replaying the staged assignment.  Only
    # a resumed run may find the CRF already applied: a fresh run's maps
    # start anew, whatever the state file left by the last run says
    crf_active = crf and not (mode_mm == "r+"
                              and state_crf_applied(state_path, cfg_key))
    crf_opts = dict(crf_opts or {})

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
        wrote(sp)
        y0, y1, x0, x1 = box
        mean_map[y0:y1, x0:x1] = refined
        crf_tile_done(ti, sp)

    # --- inference --------------------------------------------------------
    if inference_mode == "tile":
        from .tile_infer import run_tile_inference

        if (supertile + patch_size) % 32 != 0:
            raise ValueError(
                "tile mode needs (supertile + patch_size) divisible by 32")
        if tile_local_aspp and supertile % patch_size == 0:
            # DeepLab's image pooling is global over its input; over a
            # supertile that would change its context from the reference's
            # patches.  Rebuild it with patch-sized pooling windows, its own
            # kwargs, the same weights and the same int8 ranges (no
            # parameter depends on the window)
            from ..models.quant import calib_of, set_calib

            for i, b in enumerate(bundles):
                if b.name == "deeplabv3":
                    bundles[i] = registry.build_model(
                        b.name, dtype=compute_dtype,
                        aspp_pool_window=patch_size, **model_kws[b.name])
                    m = bundles[i].module.to(device).eval()
                    m.load_state_dict(variables_list[i].state_dict())
                    set_calib(m, calib_of(variables_list[i]))
                    variables_list[i] = m
        tile_crf_cb = None
        if crf_active:
            # each supertile's mean is final at its flush in tile mode, so
            # the CRF runs right there (ops/crf.refine_tile, the post-pass's
            # own bucket-padded form) instead of as a serial tail
            from ..ops.crf import refine_tile, slide_tile_index

            def tile_crf_cb(g, img_tile, dev):
                ox, oy = g.origin
                ti = slide_tile_index(oy, ox, X, supertile)
                if ti in crf_tiles_done:
                    return
                th = min(supertile, Y - oy)
                tw = min(supertile, X - ox)
                probs = np.asarray(mean_map[oy:oy + th, ox:ox + tw],
                                   np.float32)
                if probs.max() <= 0:
                    return  # glass only: the post-pass skips it alike
                refined = refine_tile(np.asarray(img_tile[:th, :tw]), probs,
                                      supertile, device=dev, **crf_opts)
                crf_write(ti, (oy, oy + th, ox, ox + tw), refined)

        run_tile_inference(
            slide, plan, bundles, tuple(variables_list), tta_full,
            mean_map, var_map, count_map, halo=patch_size // 2,
            status=status, timer=timer, progress_cb=progress_cb,
            compute_dtype=compute_dtype, completed=completed,
            on_group_done=lambda gi: save_state(),
            faithful_tta=faithful_tta, spatial_shard=spatial_shard,
            crf_cb=tile_crf_cb, bbox_compute=tile_bbox_compute,
            state_lock=state_lock, devices=devices)
    else:
        # counts are computed on the host (add_counts_host), so the
        # accumulator carries mean + var; with one prediction per patch the
        # variance is identically zero and its plane is not fetched
        n_preds = len(bundles) * len(tta_full)
        fetch_planes = 1 if n_preds == 1 else 2
        # one shard per device, with its own replica and accumulator; the
        # flush sums the accumulators.  The shards are issued from this
        # thread: from a thread each, two shards of a batch-32 forward on
        # one H100 took twice as long (chip_smoke.py phase 5a)
        replicas = par.replicas(variables_list, devices)
        if n_dev > 1:
            sharded = par.build_sharded_step(
                bundles, tta_full, patch_size, devices,
                faithful_tta=faithful_tta, compute_dtype=compute_dtype,
                mask_predictions=mask_predictions)

            def run_batch(accs, b):
                sharded(replicas, accs, par.shard_batch(
                    devices, b.patches, b.offsets, b.valid))
        else:
            step = build_step(bundles, tta_full, patch_size,
                              faithful_tta=faithful_tta,
                              compute_dtype=compute_dtype,
                              mask_predictions=mask_predictions,
                              device=device)

            def run_batch(accs, b):
                step(replicas[0], accs[0], b.patches, b.offsets, b.valid)
        acc_side = supertile + patch_size
        total_batches = max(plan.total_batches, 1)
        done = sum(len(plan.groups[gi].coords) // global_batch
                   for gi in completed if gi < len(plan.groups))

        def flush(accs, gi):
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
                with timer.stage("flush.fetch"):
                    host = (par.reduce_accumulator(accs, (
                        slice(0, fetch_planes), slice(rx0, rx0 + sx),
                        slice(ry0, ry0 + sy)))
                            .transpose(1, 2).contiguous().cpu().numpy())
                with timer.stage("flush.state"):
                    # taint marker: += is not replayable
                    save_state(inflight=gi)
                with timer.stage("flush.accumulate"):
                    # host block is (planes, sy, sx) at map offset
                    # (oy+ry0, ox+rx0)
                    wy = min(sy, hy - ry0)
                    wx = min(sx, hx - rx0)
                    my, mx = oy + ry0, ox + rx0
                    mean_map[my:my + wy, mx:mx + wx] += host[0, :wy, :wx]
                    if fetch_planes > 1:
                        var_map[my:my + wy, mx:mx + wx] += host[1, :wy, :wx]
                    add_counts_host(count_map, g.coords, g.valid, patch_size)
                with state_lock:
                    completed.add(gi)
                with timer.stage("flush.state"):
                    save_state()  # clears the inflight taint

        accs = None
        cur_group = -1
        with ThreadPoolExecutor(1, thread_name_prefix="flusher") as flusher:
            pending = []
            batches = iter(PatchLoader(slide, plan, num_workers=num_workers,
                                       skip_groups=completed))
            while True:
                with timer.stage("loader_wait"):
                    batch = next(batches, None)
                if batch is None:
                    break
                if batch.group_index != cur_group:
                    if accs is not None:
                        # flush in the background while the next supertile runs
                        pending.append(flusher.submit(flush, accs, cur_group))
                        # each pending flush pins D device accumulators
                        while len(pending) > 2:
                            with timer.stage("flush_wait"):
                                pending.pop(0).result()
                    accs = par.make_sharded_accumulator(
                        devices, supertile, patch_size, planes=2)
                    cur_group = batch.group_index
                with timer.stage("infer"):
                    run_batch(accs, batch)
                done += 1
                _status_set(status, progress=int(done * 100.0 / total_batches))
                if progress_cb is not None:
                    progress_cb(done, total_batches)
            if accs is not None:
                pending.append(flusher.submit(flush, accs, cur_group))
            with timer.stage("flush_wait"):
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
            with timer.stage("finalize.sync"):
                mean_map.flush()
                var_map.flush()
        finalized = True
        save_state(mark_finalized=True)

    # --- CRF post-pass: every tile not refined yet (all of them in patch
    # mode, those a crash interrupted in tile mode) -----------------------
    if crf_active:
        from ..ops.crf import refine_slide_crf

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
                             device=device, **crf_opts)
        mark_crf_applied(state_path, cfg_key)
        wrote(state_path)

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
                                 scratch_dir=str(mdir), timer=timer) as wr:
            wr.write_base(mm)

    def write_u8(path, transform, scratch="u8"):
        """``transform(y0, y1)``'s rows into the 8-bit memmap
        ``<stem>-<scratch>.dat``, synced, then its pyramid at ``path``;
        returns the memmap."""
        with timer.stage("write"):
            with timer.stage("write.quantize"):
                mm = np.memmap(mdir / f"{stem}-{scratch}.dat", np.uint8, "w+",
                               shape=(Y, X))
                for y0 in range(0, Y, CHUNK):
                    y1 = min(y0 + CHUNK, Y)
                    mm[y0:y1] = transform(y0, y1)
            with timer.stage("write.sync"):
                mm.flush()
            wrote(mm.filename)
            with timer.stage("write.pyramid"):
                write_u8_pyramid(path, mm)
            wrote(path)
        return mm

    write_u8(probs_path, lambda a, b: np.clip(
        np.round(mean_map[a:b] * 255.0), 0, 255).astype(np.uint8))
    if save_float_probs:
        f32_path = str(probs_path) + ".f32.tiff"
        with timer.stage("write"), timer.stage("write.pyramid"), \
                PyramidalTiffWriter(f32_path, X, Y, channels=1,
                                    dtype=np.float32, compression="deflate",
                                    scratch_dir=str(mdir), timer=timer) as wr:
            wr.write_base(mean_map)
        wrote(f32_path)

    _status_set(status, progress=100)
    _status_set(status, status="Saving Prediction Mask...")
    mask_mm = write_u8(mask_path, lambda a, b: np.where(
        mean_map[a:b] >= threshold, 255, 0).astype(np.uint8), "maskbin")

    _status_set(status, status="Saving Prediction Uncertanity...")
    write_u8(uncertainty_path, lambda a, b: np.clip(
        np.round(var_map[a:b] * 255.0), 0, 255).astype(np.uint8))
    _status_set(status, progress=0)

    timings = timer.summary()
    _status_set(status, timings=timings)
    print(f"[dpai-torch] {plan.total_patches} patches "
          f"({len(plan.groups)} supertiles, {n_dev} device(s) "
          f"{[str(d) for d in devices]}): {timings}")

    slide.close()
    # the reference returns the thresholded map in (X, Y) orientation
    return mask_mm.T
