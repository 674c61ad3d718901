"""Two processes of the port over torch.distributed (gloo, on the CPU) ==
the reference's spectrum_reads.

Each child process holds 4 shards of an 8-shard mesh
(parallel/multihost.global_mesh), keeps its contiguous half of a seeded
read batch (host_batch_to_global) and runs distributed_spectrum at K=24;
the all_to_all crosses processes in one all_to_all_single. The parent
holds every child's spectrum, dropped count and n_unique against the
reference's 1-device kmer.count.spectrum_reads on the whole batch, as
tests/test_multihost.py holds the reference's two-process run. The
children import only the port.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.kmer import count as rcount  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
import numpy as np
import torch
pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
from allpathslg_tpu_torch.parallel import multihost as mh
from allpathslg_tpu_torch.parallel.dist_count import distributed_spectrum
import torch.distributed as dist

mh.initialize(coordinator=f"127.0.0.1:{port}", num_processes=nproc,
              process_id=pid, backend="gloo")
assert dist.get_rank() == pid and dist.get_world_size() == nproc
paths = [f"reads_{i}.npz" for i in range(8)]
mine = mh.my_file_shard(paths)
assert mine == paths[pid::nproc], mine
m = mh.global_mesh(4, device="cpu")
assert (m.size, m.n_local, m.rank, m.backend) == (4 * nproc, 4, pid, "gloo")
rng = np.random.default_rng(7)
codes = rng.integers(0, 4, size=(64, 60)).astype(np.uint8)
codes[rng.random(codes.shape) < 0.01] = 4
rows = codes.shape[0] // nproc
local = mh.host_batch_to_global(codes[pid * rows:(pid + 1) * rows], m)
spec, dropped, words, counts, nu = distributed_spectrum(
    m, local, K=24, capacity_factor=4.0, max_freq=63)
parts = [torch.zeros_like(nu) for _ in range(nproc)]
dist.all_gather(parts, nu)
np.savez(out, spec=spec.numpy(), dropped=int(dropped),
         nu=torch.cat(parts).numpy())
dist.destroy_process_group()
print(f"proc {pid} ok", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_distributed_spectrum(tmp_path):
    port = _free_port()
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), "2", str(port),
         str(tmp_path / f"out{pid}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=str(ROOT)) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost children timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} ok" in out

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=(64, 60)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    want_spec, want_nu = rcount.spectrum_reads(jnp.asarray(codes), 24, 63)
    for pid in (0, 1):
        got = np.load(tmp_path / f"out{pid}.npz")
        assert int(got["dropped"]) == 0
        assert (got["spec"] == np.asarray(want_spec)).all()
        assert got["nu"].shape == (8,)
        assert int(got["nu"].sum()) == int(want_nu)
