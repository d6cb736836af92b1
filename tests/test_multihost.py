"""Multi-host (multi-process) smoke: 2 real processes joined with
``jax.distributed`` over localhost, one shard_map gradient-``pmean``
across them (round-2 VERDICT #7 — ``parallel/multihost.py`` must have a
caller that passes in CI).

The transport on CPU is Gloo over gRPC; on a GPU cluster the identical
``initialize_from_env`` + ``Mesh``/``shard_map`` code rides NCCL over
NVLink and the network (SURVEY §5 distributed-backend item).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_dp_step(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    env_base = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "PYTHONPATH", "JAX_PLATFORMS")
    }
    procs = []
    for i in range(2):
        env = dict(
            env_base,
            NLSH_COORDINATOR=f"127.0.0.1:{port}",
            NLSH_NUM_PROCESSES="2",
            NLSH_PROCESS_ID=str(i),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            PYTHONPATH=str(REPO),
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "multihost_child.py"),
             str(outs[i])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"child failed:\n{log}"

    results = [json.loads(o.read_text()) for o in outs]
    for i, r in enumerate(results):
        assert r["initialized"] is True
        assert r["n_processes"] == 2
        assert r["n_global_devices"] == 4  # 2 processes x 2 cpu devices
        assert r["process_index"] == i

    # both processes computed the SAME globally-reduced results:
    # batch rows are [1,1] on process 0 (8 rows) and [2,2] on process 1,
    # w=[2,-1] -> x@w = v per row of value v;
    # psum(sum(x)) = 8*2*1 + 8*2*2 = 48
    assert results[0]["psum"] == results[1]["psum"] == 48.0
    assert results[0]["grad"] == results[1]["grad"]
    # g = psum over the 4 devices of the local grad of
    # mean_local((x@w)^2): per device with 4 rows of value v the local
    # grad is [2v^2, 2v^2] -> psum = (2+2+8+8) = 20 per component.
    # A missing cross-process reduction would give 4 or 16 instead.
    assert results[0]["grad"] == [20.0, 20.0]
