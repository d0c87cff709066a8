#!/usr/bin/env python
"""Segment every slide in a directory with the PyTorch port, on every
local card (a test-set sweep; ``examples/batch_segment.py``'s twin on
``digipathai_tpu_torch``).

    python examples/batch_segment_torch.py /data/camelyon_test --mode breast \\
        --inference-mode tile

Each process runs ``getSegmentation(..., data_parallel=True)``: in patch
mode every batch is split over all of its host's cards (grid-dp), in tile
mode the supertiles are dealt round-robin over them.

Multi-host: each host takes slides[process_id::num_processes] and segments
them with its local cards; launch one process per host:

    # host 0                                        # host 1
    python examples/batch_segment_torch.py DIR \\   python examples/batch_segment_torch.py DIR \\
      --coordinator h0:8476 \\                        --coordinator h0:8476 \\
      --num-processes 2 --process-id 0              --num-processes 2 --process-id 1

(or set DPAI_COORDINATOR / DPAI_NUM_PROCESSES / DPAI_PROCESS_ID).  The
process group is nccl with ``--device cuda`` (the default) and gloo with
``--device cpu``; it only splits the slides and counts them at the end.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("slide_dir")
    ap.add_argument("--mode", default="breast",
                    choices=["colon", "liver", "breast"])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--model", default="dense")
    ap.add_argument("--tta", nargs="*", default=None)
    ap.add_argument("--crf", action="store_true")
    ap.add_argument("--inference-mode", default="patch",
                    choices=["patch", "tile"])
    ap.add_argument("--resume", action="store_true",
                    help="skip completed supertiles of interrupted runs")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-host runs)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible card, the default) or cpu")
    args = ap.parse_args(argv)

    from digipathai_tpu_torch.parallel import distributed as dist

    dist.initialize(coordinator=args.coordinator,
                    num_processes=args.num_processes,
                    process_id=args.process_id, device=args.device)

    from digipathai_tpu_torch import Slide, getSegmentation
    from digipathai_tpu_torch.server.app import get_mask_path_basename

    slides = []
    for name in sorted(os.listdir(args.slide_dir)):
        p = os.path.join(args.slide_dir, name)
        if not Slide.detect_format(p):
            continue
        if "dgai-mask" in name or "dgai-uncertainty" in name or "-gt" in name:
            continue
        slides.append(p)
    mine = dist.shard_slides(slides)
    pid, n_proc = dist.process_index(), dist.process_count()
    print(f"{len(slides)} slides total; host {pid}/{n_proc} takes {len(mine)}")

    total_t0 = time.time()
    for i, p in enumerate(mine):
        root, ext = os.path.splitext(p)
        t0 = time.time()
        getSegmentation(
            img_path=p, quick=args.quick, model=args.model, mode=args.mode,
            tta_list=args.tta, crf=args.crf,
            probs_path=root + "-dgai-probs" + ext,
            mask_path=get_mask_path_basename(p) + ext,
            uncertainty_path=root + "-dgai-uncertainty" + ext,
            inference_mode=args.inference_mode, resume=args.resume,
            data_parallel=True, device=args.device)
        print(f"[{i + 1}/{len(mine)}] {os.path.basename(p)}: "
              f"{time.time() - t0:.1f}s", flush=True)
    dist.barrier()
    done = dist.all_hosts_total(len(mine))
    print(f"host total: {time.time() - total_t0:.1f}s; "
          f"all hosts segmented {int(done)} slides", flush=True)
    dist.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
