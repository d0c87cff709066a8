#!/usr/bin/env python3
"""Where the spatially sharded forward's time goes: host issue against total.

    python3 tools/torch_sp_host.py [dense|inception|deeplabv3 ...]

On the card(s) of this machine, for each model named (default dense) as
tile mode builds it (bf16, seeded weights; the U-Nets with
fused_stages=5, DeepLab with aspp_pool_window=256), the forward of one
normalized 4352^2 supertile: serial on cuda:0; two serial forwards of a
strip-sized input (the rows of one of two strips and a margin); then
row-sharded over each device list (``parallel/spatial.py::StripThreads``,
as the tile step runs them): two and four strips on cuda:0, and a strip
per card on two cards and on every card where there are that many, the
last list also on threads started for each forward (``run_lockstep``).
For each, the median over 5 runs (after one warm-up) of the host time
until the forward returns and of the total until every card is done, and
for the sharded forwards the summed time the strips' threads waited for
their turn.  Last, the cost of one exchange round alone (the baton going
once round the strips, ``spatial.shape`` on a tiny tensor).  Prints one
line each and the card's name and power limit.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from digipathai_tpu_torch import _build  # noqa: E402
from digipathai_tpu_torch.models.registry import build_model  # noqa: E402
from digipathai_tpu_torch.parallel import spatial  # noqa: E402
from digipathai_tpu_torch.parallel.inference import replicas  # noqa: E402

REPS = 5


def model(name, x, waited, smi):
    """The serial and sharded forwards of one model (see the module
    docstring)."""
    kw = ({"aspp_pool_window": cs.PATCH} if name == "deeplabv3"
          else {"fused_stages": 5})
    m = build_model(name, dtype=torch.bfloat16, **kw).init(
        cs.PATCH, seed=0).cuda()
    half = x[:, :cs.TILE_SIDE // 2 + 128].contiguous()
    with torch.inference_mode():
        host, total, _ = measure(lambda: m(x), waited)
        print(f"{name} serial forward {tuple(x.shape)}: host {host:.1f} ms, "
              f"total {total:.1f} ms | {smi}", flush=True)
        host, total, _ = measure(lambda: [m(half) for _ in range(2)], waited)
        print(f"{name} two serial forwards of {tuple(half.shape)}: host "
              f"{host:.1f} ms, total {total:.1f} ms | {smi}", flush=True)
    cards = torch.cuda.device_count()
    layouts = [["cuda:0"] * 2, ["cuda:0"] * 4]
    layouts += [[f"cuda:{i}" for i in range(n)] for n in (2, 4)
                if n <= cards]
    for names in layouts:
        devices = [torch.device(d) for d in names]
        mods = [r[0] for r in replicas([m], devices)]
        with torch.inference_mode(), spatial.StripThreads(
                len(devices)) as threads:
            host, total, waits = measure(lambda: threads.run(
                lambda mm, xs: mm(xs), mods,
                spatial.shard_rows(x, devices)), waited)
        print(f"{name} sharded forward on {names}: host {host:.1f} ms (the "
              f"strips waited {waits:.1f} ms for their turn, summed), total "
              f"{total:.1f} ms | {smi}", flush=True)
        if names == layouts[-1]:
            # the same on threads started for each forward: cuDNN's plan
            # cache is per thread, so every conv is planned again
            with torch.inference_mode():
                host, total, _ = measure(lambda: spatial.run_lockstep(
                    lambda mm, xs: mm(xs), mods,
                    spatial.shard_rows(x, devices)), waited)
            print(f"{name} sharded forward on {names}, fresh threads per "
                  f"forward: host {host:.1f} ms, total {total:.1f} ms | "
                  f"{smi}", flush=True)
        del mods
        torch.cuda.empty_cache()
    del m
    torch.cuda.empty_cache()


def measure(fn, waited):
    """(host ms, total ms, waited ms): medians over REPS runs."""
    cards = torch.cuda.device_count()
    fn()
    hosts, totals, waits = [], [], []
    for _ in range(REPS):
        for i in range(cards):
            torch.cuda.synchronize(i)
        waited[0] = 0.0
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        for i in range(cards):
            torch.cuda.synchronize(i)
        hosts.append(1e3 * (t1 - t0))
        totals.append(1e3 * (time.perf_counter() - t0))
        waits.append(1e3 * waited[0])
    return (statistics.median(hosts), statistics.median(totals),
            statistics.median(waits))


def main(names):
    if not torch.cuda.is_available():
        print("torch_sp_host: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    _build.build_all()
    smi = cs.smi_line()
    waited = [0.0]
    wait = spatial._Lockstep._wait

    def timed_wait(self, rank):
        t = time.perf_counter()
        try:
            wait(self, rank)
        finally:
            waited[0] += time.perf_counter() - t

    spatial._Lockstep._wait = timed_wait
    x = cs.tile_input()
    for name in names:
        model(name, x, waited, smi)
    tiny = torch.zeros(1, 8, 4, 2, device="cuda:0")
    rounds = 1000
    for d in (2, 4):
        def spin(i, b):
            for _ in range(rounds):
                spatial.shape(b)
            return b

        t = time.perf_counter()
        spatial.run_lockstep(spin, list(range(d)),
                             spatial.shard_rows(tiny, ["cuda:0"] * d))
        print(f"one exchange round over {d} strips: "
              f"{1e6 * (time.perf_counter() - t) / rounds:.1f} us",
              flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["dense"]))
