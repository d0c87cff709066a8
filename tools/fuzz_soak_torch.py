"""Exploratory fuzz soak over ALL slide readers of the PyTorch port.

The counterpart of ``tools/fuzz_soak.py`` on ``digipathai_tpu_torch``:
``probe`` opens the port's ``Slide``.  The mutants come from the makers of
``tests/fixtures.py`` (test data; ``tools/torch_fixtures.py`` points their
writer imports at the port's byte copies), over every container format,
byteflip + wordsplat + truncation mutations, with the same seeds as the
JAX soak.  Any exception outside the documented
ValueError/OSError/struct.error contract is recorded with exact repro info
(format, mutation kind, seed, index) to dpai_fuzz_soak_torch_findings.txt
in the temporary directory (``tempfile.gettempdir()``, which follows
TMPDIR); the fixtures are written to a fresh directory there and removed
at the end.

Usage: python tools/fuzz_soak_torch.py   (the readers run on the CPU)
"""
import os
import shutil
import struct
import sys
import tempfile
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import numpy as np  # noqa: E402

from digipathai_tpu_torch.io.slide import Slide  # noqa: E402
from torch_fixtures import load as _fixtures  # noqa: E402

ALLOWED = (ValueError, OSError, struct.error)
SPLATS = (0, 1, 0x7FFFFFFF, 0xFFFFFFFF, 0x80000000, 0x00010000)
FINDINGS_PATH = os.path.join(tempfile.gettempdir(),
                             "dpai_fuzz_soak_torch_findings.txt")
_findings = None


def finding(msg):
    global _findings
    if _findings is None:
        _findings = open(FINDINGS_PATH, "a", buffering=1)
    _findings.write(msg)


def probe(path):
    try:
        Slide.detect_format(str(path))
    except BaseException:
        return "detect_format RAISED:\n" + traceback.format_exc()
    try:
        s = Slide(str(path))
        try:
            s.read_region((0, 0), 0, (64, 64))
            lvl = s.level_count - 1
            dims = s.level_dimensions[lvl]
            s.read_region((max(0, dims[0] - 32), max(0, dims[1] - 32)),
                          lvl, (64, 64))
        finally:
            s.close()
    except ALLOWED:
        pass
    except BaseException:
        return traceback.format_exc()
    return None


def mutate_and_probe(tag, src_path, aux_targets=(), n_flip=400, n_splat=250,
                     n_trunc=24, seed0=20_000):
    """Mutate the primary file (and each aux file) of a fixture in place."""
    ok = probe(src_path)
    if ok is not None:
        print(f"[{tag}] CLEAN FIXTURE FAILS:\n{ok}")
        return 1
    bad = 0
    targets = [src_path] + list(aux_targets)
    for t_i, target in enumerate(targets):
        data = open(target, "rb").read()
        if not data:
            continue
        backup = data
        rng = np.random.default_rng(seed0 + t_i)

        def runcase(kind, idx, blob):
            nonlocal bad
            open(target, "wb").write(blob)
            r = probe(src_path)
            if r is not None:
                bad += 1
                msg = (f"[{tag}] target={os.path.basename(target)} "
                       f"kind={kind} idx={idx} seed={seed0 + t_i}\n{r}\n")
                print(msg)
                finding(msg)

        for i in range(n_flip):
            m = bytearray(data)
            for _ in range(int(rng.integers(1, 9))):
                off = int(rng.integers(0, len(data)))
                m[off] ^= int(rng.integers(1, 256))
            runcase("byteflip", i, bytes(m))
        for i in range(n_splat):
            m = bytearray(data)
            off = int(rng.integers(0, max(1, len(data) - 4))) & ~3
            m[off:off + 4] = struct.pack(
                "<I", SPLATS[int(rng.integers(0, len(SPLATS)))])
            runcase("wordsplat", i, bytes(m))
        n = len(data)
        for i, size in enumerate(sorted({int(x) for x in
                                         rng.integers(0, n, n_trunc)})):
            runcase("trunc", i, data[:size])
        open(target, "wb").write(backup)
    print(f"[{tag}] done, {bad} contract violations")
    return bad


def main():
    fx = _fixtures()
    base = tempfile.mkdtemp(prefix="dpai_fuzz_soak_torch_")
    print(f"findings go to {FINDINGS_PATH}")
    try:
        total = soak(fx, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(f"TOTAL contract violations: {total}")


def soak(fx, base):
    total = 0

    d = mk(base, "tiff")
    fx.make_synthetic_slide(d + "/s.tiff", width=512, height=384)
    total += mutate_and_probe("tiff", d + "/s.tiff", seed0=21_000)

    d = mk(base, "svs")
    fx.make_svs_like_slide(d + "/s.svs")
    total += mutate_and_probe("svs", d + "/s.svs", seed0=22_000)

    d = mk(base, "ndpi")
    fx.make_ndpi_slide(d + "/s.ndpi")
    total += mutate_and_probe("ndpi", d + "/s.ndpi", seed0=23_000)

    d = mk(base, "scn")
    fx.make_scn_slide(d + "/s.scn")
    total += mutate_and_probe("scn", d + "/s.scn", seed0=24_000)

    d = mk(base, "philips")
    fx.make_philips_slide(d + "/s.tiff")
    total += mutate_and_probe("philips", d + "/s.tiff", seed0=25_000)

    d = mk(base, "ventana")
    fx.make_ventana_slide(d + "/s.bif")
    total += mutate_and_probe("ventana", d + "/s.bif", seed0=26_000)

    d = mk(base, "trestle")
    fx.make_trestle_slide(d + "/s.tif")
    total += mutate_and_probe("trestle", d + "/s.tif", seed0=27_000)

    d = mk(base, "sakura")
    fx.make_sakura_slide(d + "/s.svslide")
    total += mutate_and_probe("sakura", d + "/s.svslide", seed0=28_000)

    d = mk(base, "vms")
    fx.make_vms_slide(d + "/s.vms", width=256, height=128, columns=2)
    aux = [d + "/" + f for f in os.listdir(d) if f != "s.vms"]
    total += mutate_and_probe("vms", d + "/s.vms", aux, seed0=29_000,
                              n_flip=150, n_splat=100)

    d = mk(base, "vmu")
    fx.make_vmu_slide(d + "/s.vmu", width=128, height=64)
    aux = [d + "/" + f for f in os.listdir(d) if f != "s.vmu"]
    total += mutate_and_probe("vmu", d + "/s.vmu", aux, seed0=30_000,
                              n_flip=150, n_splat=100)

    d = mk(base, "mirax")
    fx.make_mirax_slide(d + "/s.mrxs")
    aux = []
    for root, _, files in os.walk(d + "/s"):
        aux += [os.path.join(root, f) for f in files]
    total += mutate_and_probe("mirax", d + "/s.mrxs", aux, seed0=31_000,
                              n_flip=120, n_splat=80, n_trunc=12)

    return total


def mk(base, name):
    d = os.path.join(base, name)
    os.makedirs(d, exist_ok=True)
    return d


if __name__ == "__main__":
    main()
