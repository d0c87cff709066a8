"""The port's multi-process runtime and data-parallel train step on gloo.

Two localhost processes, started as ``tests/test_distributed.py`` starts
its pair, join one process group through ``parallel.distributed``
(``initialize`` with a TCP coordinator), check the bootstrap, the slide
sharding, the barrier and the all-host total, and run
``training.train.make_dp_train_step`` with half of one batch of 8 each.
The test process runs the serial step on the whole batch from the same
seeded state: the dp step must give its loss, its gradients and its new
BatchNorm statistics (global statistics, global Dice).

TinyUNet runs in f32.  The DenseNet (``blocks=(1, 1, 1, 1)``) runs in f64:
its f32 gradient is ill-conditioned at this size (the serial f32 step's
gradient is 6e-2 of a leaf's scale from the f64 one, as JAX's own f32
gradient is in ``test_torch_training.py``), so a reordered sum moves it by
far more than its rounding; in f64 the dp step is within 7.7e-7 of the
serial one (the softmax and the loss stay f32).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SIZE = 8, 64
MODELS = {"tiny": dict(dtype=torch.float32),
          "dense": dict(dtype=torch.float64, blocks=(1, 1, 1, 1))}
LOSS_TOL = 1e-5       # relative
GRAD_TOL = 1e-5       # of each leaf's scale
FLOOR = 1e-3          # test_torch_training.py: a zero gradient's noise
STATS_TOL = 1e-6

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    coordinator, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    from digipathai_tpu_torch.parallel import distributed as dist
    from digipathai_tpu_torch.models.bridge import torch_to_flax
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.training.train import (init_state,
                                                     make_dp_train_step)
    from tests.test_torch_distributed import MODELS, batch
    for _ in range(2):  # idempotent
        dist.initialize(coordinator=coordinator, num_processes=2,
                        process_id=pid, device="cpu")
    shard = dist.shard_slides([f"s{i}" for i in range(5)])
    result = {"pid": dist.process_index(), "count": dist.process_count(),
              "shard": shard, "grand": dist.all_hosts_total(len(shard))}
    dist.barrier()
    arrays = {}
    for name, kw in MODELS.items():
        bundle = build_model(name, **kw)
        state = init_state(bundle, 64, device="cpu")
        x, y = batch()
        half = slice(pid * len(x) // 2, (pid + 1) * len(x) // 2)
        loss = make_dp_train_step()(state, x[half], y[half])
        arrays[f"{name}/loss"] = loss.numpy()
        for k, p in state.model.named_parameters():
            arrays[f"{name}/grad/{k}"] = p.grad.double().numpy()
        for k, v in torch_to_flax(state.model).get("batch_stats", {}).items():
            for leaf, a in v.items():
                arrays[f"{name}/stats/{k}.{leaf}"] = a
    np.savez(out, **arrays)
    dist.barrier()
    print("RESULT " + json.dumps(result))
""")


def batch():
    """The global batch: (8, 64, 64, 3) patches, one-hot labels."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (BATCH, SIZE, SIZE))]
    return torch.from_numpy(x), torch.from_numpy(y)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(script, out_dir, timeout=300):
    """Process 0 and 1 on one coordinator -> their (returncode, output)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    for k in ("DPAI_COORDINATOR", "DPAI_NUM_PROCESSES", "DPAI_PROCESS_ID"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"127.0.0.1:{port}", str(pid),
         str(out_dir / f"rank{pid}.npz")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return outs


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    script = d / "worker.py"
    script.write_text(WORKER)
    outs = _run_pair(script, d)
    results = {}
    for rc, out in outs:
        assert rc == 0, out[-3000:]
        line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
        r = json.loads(line[len("RESULT "):])
        results[r["pid"]] = r
    ranks = [dict(np.load(d / f"rank{pid}.npz")) for pid in (0, 1)]
    return results, ranks


def test_two_process_bootstrap_sharding_and_total(pair):
    results, _ = pair
    assert results[0]["count"] == results[1]["count"] == 2
    # round-robin sharding: disjoint, covering
    assert results[0]["shard"] == ["s0", "s2", "s4"]
    assert results[1]["shard"] == ["s1", "s3"]
    assert results[0]["grand"] == results[1]["grand"] == 5.0


@pytest.mark.parametrize("name", list(MODELS))
def test_dp_step_equals_the_serial_step(pair, name):
    """Two ranks with half the batch each give the serial step's loss,
    gradients and BatchNorm statistics on the whole batch (the DenseNet's
    BatchNorms take the global batch's statistics)."""
    from digipathai_tpu_torch.models.bridge import torch_to_flax
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.training.train import (init_state,
                                                     make_train_step)

    _, ranks = pair
    bundle = build_model(name, **MODELS[name])
    state = init_state(bundle, SIZE, device="cpu")
    loss = float(make_train_step()(state, *batch()))
    grads = {k: p.grad.double().numpy()
             for k, p in state.model.named_parameters()}
    stats = {f"{k}.{leaf}": a for k, v in torch_to_flax(
        state.model).get("batch_stats", {}).items() for leaf, a in v.items()}
    assert bool(stats) == (name == "dense")
    top = max(np.abs(g).max() for g in grads.values())
    for r in ranks:
        assert abs(float(r[f"{name}/loss"]) - loss) <= LOSS_TOL * abs(loss)
        for k, g in grads.items():
            err = np.abs(r[f"{name}/grad/{k}"] - g).max()
            assert err <= GRAD_TOL * max(np.abs(g).max(), FLOOR * top), k
        for k, s in stats.items():
            assert np.abs(r[f"{name}/stats/{k}"] - s).max() <= STATS_TOL, k
    # the ranks hold one state
    for k in ranks[0]:
        if k.startswith(name):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


def test_single_process_is_a_no_op(monkeypatch):
    """No coordinator: nothing starts, and every call is the identity."""
    import torch.distributed

    from digipathai_tpu_torch.parallel import distributed as dist

    for k in ("DPAI_COORDINATOR", "DPAI_NUM_PROCESSES", "DPAI_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    dist.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert dist.shard_slides(["a", "b", "c"]) == ["a", "b", "c"]
    dist.barrier()
    assert dist.all_hosts_total(3) == 3.0
