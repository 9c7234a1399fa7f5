"""The port's multi-process glue, as tests/test_multihost.py holds islx's:
two CPU processes join one run through ``torch.distributed`` (gloo) on a
free local port, each with a mesh of two copies of the CPU device.

Each process places its own rows (``global_batch_from_local``: the global
offset and count, no data crossing processes) and the all-reduced sum
and mean are the global batch's (72 and 1.5). Then each takes one
data-parallel head train step on its half of a seeded batch: the
gradients, summed over the processes, must equal a one-process step on the
whole batch with the same dropout generator (rtol 1e-4, atol 1e-6, as
tests/test_torch_train.py holds gradients; the loss within 1e-5), and the
two processes' must be equal. Every wait has its own timeout, so a hang
fails the test rather than stalling the suite.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from islx_torch.core.config import TranslatorConfig
from islx_torch.isl import train as TR
from islx_torch.models import translator as T
from islx_torch.parallel import mesh as M

pid = int(sys.argv[1])
active = M.init_distributed(coordinator_address={coord!r},
                            num_processes=2, process_id=pid)
assert active, "init_distributed returned False"
assert M.init_distributed() is True          # a second call is a no-op
assert (dist.get_rank(), dist.get_world_size()) == (pid, 2)

mesh = M.make_mesh(devices=[torch.device("cpu")] * 2)   # (data=2, model=1)
local = np.full((4, 6), float(pid + 1), np.float32)
gb = M.global_batch_from_local(mesh, local)
assert (gb.offset, gb.count, gb.local_count) == (4 * pid, 8, 4)
assert [s.shape for s in gb.shards] == [(2, 6), (2, 6)]
total = torch.stack([s.sum() for s in gb.shards]).sum()
dist.all_reduce(total)
assert abs(float(total) - 72.0) < 1e-4, float(total)
mean = float(total) / (gb.count * 6)
assert abs(mean - 1.5) < 1e-6, mean

x = np.load({data!r})
cfg = TranslatorConfig()
state = TR.init_state(cfg, 1e-3, T.init_params(cfg, 0), device="cpu")
step = TR.make_train_step(state, mesh)
rows = slice(8 * pid, 8 * pid + 8)
m = step(torch.from_numpy(x["x"][rows]), torch.from_numpy(x["y"][rows]),
         torch.Generator().manual_seed(7))
head = state.head
grads = {{}}
for name, keys in head._keys.items():
    for k in keys:
        if name.startswith("bn") and k in ("mean", "var"):
            continue
        parts = [p.grad for p in head.parts(name, k)]
        grads[f"{{name}}__{{k}}"] = parts[0].numpy()
np.savez({out!r} + f"/w{{pid}}.npz", loss=float(m["loss"]), **grads)
dist.destroy_process_group()
print(f"worker {{pid}} ok mean={{mean}}")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _windows(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 20, 156).astype(np.float32)
    for i, keep in enumerate(rng.randint(8, 21, n)):
        x[i, keep:] = 0.0
    return x, rng.randint(0, 167, n).astype(np.int32)


def test_two_process_global_batch_and_train_step(tmp_path):
    from islx_torch.core.config import TranslatorConfig
    from islx_torch.isl import train as TR
    from islx_torch.models import translator as T

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    x, y = _windows(1, 16)
    data = str(tmp_path / "batch.npz")
    np.savez(data, x=x, y=y)
    script = _WORKER.format(repo=repo, coord=f"127.0.0.1:{_free_port()}",
                            data=data, out=str(tmp_path))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pid)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"worker {pid} ok" in out, out

    cfg = TranslatorConfig()
    state = TR.init_state(cfg, 1e-3, T.init_params(cfg, 0), device="cpu")
    want = TR.make_train_step(state)(torch.from_numpy(x), torch.from_numpy(y),
                                     torch.Generator().manual_seed(7))
    got = [np.load(str(tmp_path / f"w{pid}.npz")) for pid in range(2)]
    for g in got:
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=1e-5)
    named = dict(state.head.named_parameters())
    assert len(named) == 22
    for key, p in named.items():
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
        np.testing.assert_allclose(got[0][key], p.grad.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
