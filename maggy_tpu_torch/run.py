"""Multi-process experiment launcher: the port's copy of ``maggy_tpu.run``.

    python -m maggy_tpu_torch.run --workers 3 my_script.py [script args...]

Starts ``my_script.py`` once as the driver (process 0) and ``workers - 1``
times as pod workers, wiring MAGGY_TPU_ROLE / DRIVER / SECRET / PARTITION /
BIND_PORT so the script's ``lagom(train_fn, config)`` call forms one
experiment across the processes (core/pod.py execution model). On several
hosts, run the equivalent: start the same script on every host with these
variables pointing at host 0.

The script gets ``MAGGY_TPU_NUM_EXECUTORS=<workers>`` (the configs read it)
and may use ``data_plane="local"`` for independent per-process replicas, or,
with ``--global-mesh``, call ``maggy_tpu_torch.initialize_data_plane()`` at
its top for one process group over every rank. Under ``--global-mesh`` rank
*r* is bound to card *r* (``LOCAL_RANK``): NCCL takes one rank per card, so
with CUDA visible and fewer cards than ``--workers`` the launcher refuses
before it starts anything (the ranks of a script that asks for the CPU form
a gloo group on a host without CUDA). Without it, processes may share cards
through ``MAGGY_TPU_WORKER_DEVICES``.

Elastic training (``--elastic MAX_RESTARTS``): when any rank dies, the
launcher tears the generation down and respawns every rank, since a lost
rank wedges the survivors' collectives (the reference can only retry whole
Spark tasks, rpc.py:415-437). App/run ids are pinned across generations so
every generation lands in the same experiment directory, and training
scripts resume from their latest checkpoint
(``Checkpointer.latest_step`` + ``Trainer.fit(checkpointer=...)``). The
generation number reaches scripts as ``MAGGY_TPU_GENERATION``.
"""

from __future__ import annotations

import argparse
import os
import secrets
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _visible_cards():
    """The CUDA cards this host shows, or None without CUDA (ranks of a
    script that asks for the CPU)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else None


def _spawn_rank(args, env_gen, generation: int, rank: int, port: int, tag=""):
    """Start one rank's process with the generation's wiring."""
    env = dict(env_gen)
    env["MAGGY_TPU_ROLE"] = "driver" if rank == 0 else "worker"
    env["MAGGY_TPU_PARTITION"] = str(rank)
    if args.global_mesh:
        env["LOCAL_RANK"] = str(rank)  # rank r on card r
    if rank == 0:
        env["MAGGY_TPU_BIND_PORT"] = str(port)
    stdout = stderr = None
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        stdout = open(
            os.path.join(args.log_dir, f"rank{rank}.g{generation}{tag}.out"), "wb"
        )
        stderr = open(
            os.path.join(args.log_dir, f"rank{rank}.g{generation}{tag}.err"), "wb"
        )
    proc = subprocess.Popen(
        [sys.executable, args.script, *args.script_args],
        env=env,
        stdout=stdout,
        stderr=stderr,
    )
    if stdout is not None:
        stdout.close()
        stderr.close()
    return proc


def _spawn_generation(args, base_env, generation: int):
    """Start all ranks for one generation. Fresh driver/coordinator ports per
    generation: the previous generation's sockets may linger in TIME_WAIT.
    Returns (procs, env_gen, port) so single ranks can be respawned into the
    same generation (--respawn)."""
    port = _free_port()
    env_gen = dict(base_env)
    env_gen.update(
        {
            "MAGGY_TPU_DRIVER": f"{args.host}:{port}",
            "MAGGY_TPU_GENERATION": str(generation),
        }
    )
    if args.global_mesh:
        env_gen["MAGGY_TPU_COORDINATOR"] = f"{args.host}:{_free_port()}"

    procs = {}
    for rank in range(args.workers):
        procs[rank] = _spawn_rank(args, env_gen, generation, rank, port)
    return procs, env_gen, port


def _terminate_all(procs, grace: float = 5.0) -> None:
    """SIGTERM then SIGKILL — ranks blocked in a wedged collective (their peer
    just died) may never reach a Python signal handler."""
    for proc in procs.values():
        if proc.poll() is None:
            proc.terminate()
    deadline = time.time() + grace
    for proc in procs.values():
        if proc.poll() is None:
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
    for proc in procs.values():
        if proc.poll() is None:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workers", type=int, default=2, help="total processes")
    parser.add_argument("--host", default="127.0.0.1", help="driver host")
    parser.add_argument(
        "--global-mesh",
        action="store_true",
        help="export a process-group coordinator so the script can call "
        "maggy_tpu_torch.initialize_data_plane() and form ONE process group "
        "over all processes, rank r on card r; without it each process "
        "keeps to itself",
    )
    parser.add_argument(
        "--elastic",
        type=int,
        default=0,
        metavar="MAX_RESTARTS",
        help="on any rank death, restart the whole generation (all ranks, "
        "same experiment dir) up to MAX_RESTARTS times; scripts resume "
        "from their latest checkpoint",
    )
    parser.add_argument(
        "--respawn",
        type=int,
        default=0,
        metavar="MAX_RESPAWNS",
        help="on a WORKER rank death, respawn just that rank into the live "
        "experiment (up to MAX_RESPAWNS total) — worker capacity recovery "
        "for HPO/ablation trial workers, which re-register with the "
        "running driver and keep serving trials. Driver (rank 0) death "
        "still tears the run down (or restarts it under --elastic).",
    )
    parser.add_argument(
        "--log-dir",
        default=None,
        help="capture each rank's stdout/stderr to "
        "LOG_DIR/rank<r>.g<generation>.{out,err} instead of inheriting "
        "the launcher's streams",
    )
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.workers < 1:
        parser.error("--workers must be >= 1")
    if args.elastic < 0:
        parser.error("--elastic must be >= 0")
    if args.global_mesh:
        cards = _visible_cards()
        if cards is not None and cards < args.workers:
            parser.error(
                f"--global-mesh binds rank r to card r: {args.workers} workers need "
                f"{args.workers} CUDA cards, {cards} visible"
            )

    base_env = dict(os.environ)
    base_env.update(
        {
            "MAGGY_TPU_SECRET": secrets.token_hex(16),
            "MAGGY_TPU_NUM_EXECUTORS": str(args.workers),
        }
    )
    if args.elastic:
        # every generation must land in the same experiment directory or
        # checkpoints written by generation g are invisible to g+1
        base_env.setdefault(
            "MAGGY_TPU_APP_ID", f"application_{int(time.time())}_0001"
        )
        base_env.setdefault("MAGGY_TPU_RUN_ID", "1")

    generation = 0
    procs, env_gen, port = _spawn_generation(args, base_env, generation)
    exit_code = 0
    respawns_used = 0
    try:
        remaining = dict(procs)
        while remaining:
            restart = failed = False
            for rank in list(remaining):
                if rank not in remaining:
                    continue  # removed by the driver-done wind-down below
                code = remaining[rank].poll()
                if code is None:
                    continue
                del remaining[rank]
                if code == 0:
                    if rank == 0:
                        # the driver finished the experiment: workers have
                        # nothing left to serve (a respawned trial worker may
                        # even be stuck in its connect-retry window against
                        # the now-closed server) — wind them down
                        deadline = time.time() + 10
                        while remaining and time.time() < deadline:
                            for r in list(remaining):
                                if remaining[r].poll() is not None:
                                    del remaining[r]
                            time.sleep(0.1)
                        if remaining:
                            print(
                                f"[maggy_tpu_torch.run] driver done; terminating "
                                f"lingering worker rank(s) {sorted(remaining)}",
                                file=sys.stderr,
                            )
                            _terminate_all(remaining)
                            remaining = {}
                    continue
                if rank != 0 and respawns_used < args.respawn and 0 in remaining:
                    # the driver is still up: put this worker's capacity back
                    # (it re-registers with a fresh attempt nonce; the driver
                    # frees any trial it was holding). With the driver gone
                    # there is nothing to rejoin — fall through to teardown.
                    respawns_used += 1
                    print(
                        f"[maggy_tpu_torch.run] worker rank {rank} exited with "
                        f"{code}; respawning into the live experiment "
                        f"({args.respawn - respawns_used} respawn(s) left)",
                        file=sys.stderr,
                    )
                    proc = _spawn_rank(
                        args, env_gen, generation, rank, port,
                        tag=f".r{respawns_used}",
                    )
                    procs[rank] = proc
                    remaining[rank] = proc
                    continue
                if generation < args.elastic:
                    print(
                        f"[maggy_tpu_torch.run] rank {rank} exited with {code}; "
                        f"restarting generation {generation} -> {generation + 1} "
                        f"({args.elastic - generation} restart(s) left)",
                        file=sys.stderr,
                    )
                    restart = True
                else:
                    # fail fast: a dead driver would otherwise leave workers
                    # spinning in their connect-retry window (and surviving
                    # ranks of a global mesh wedged in collectives)
                    print(
                        f"[maggy_tpu_torch.run] rank {rank} exited with {code}; "
                        "terminating remaining ranks",
                        file=sys.stderr,
                    )
                    exit_code = exit_code or code
                    failed = True
                break
            if failed:
                break
            if restart:
                _terminate_all(procs)
                generation += 1
                procs, env_gen, port = _spawn_generation(args, base_env, generation)
                remaining = dict(procs)
                continue
            time.sleep(0.1)
    except KeyboardInterrupt:
        exit_code = 130
    finally:
        _terminate_all(procs, grace=5.0)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
