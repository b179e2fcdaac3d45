"""Worker pool: spawns and reaps fabric worker subprocesses.

The pool owns the listening socket workers dial back into and the
process lifecycle (spawn, hello handshake, kill). Scheduling state —
idle / busy / warm, heartbeats, in-flight tasks — lives on the
``WorkerHandle`` but is driven by the broker, which also runs the
per-worker reader threads. Warm-pool policy (retiring a worker without
killing it so a later scale-up reuses the live process) is the broker /
autoscaler's business; the pool only ever spawns fresh processes and
kills dead ones.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import socket

from repro_torch.cloud import tasklib
from repro_torch.cloud.wire import WireError, recv_msg

_SRC_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class SpawnError(RuntimeError):
    pass


@dataclass
class WorkerHandle:
    worker_id: str
    proc: subprocess.Popen
    sock: socket.socket
    pid: int
    state: str = "idle"                 # idle | busy | warm | dead
    current: Optional[object] = None    # in-flight Task (broker-owned)
    last_heartbeat: float = field(default_factory=time.monotonic)
    warm_since: float = 0.0
    reader: Optional[threading.Thread] = None
    store: Optional[object] = None      # wire.ChannelStore (broker-owned)


class WorkerPool:
    def __init__(self, *, init_modules: Sequence[str] = ("repro_torch.cloud.tasklib",),
                 heartbeat_s: float = 0.25, spawn_timeout_s: float = 30.0,
                 python: str = sys.executable, dedup: bool = True):
        self.init_modules = tuple(init_modules)
        self.heartbeat_s = heartbeat_s
        self.dedup = dedup          # workers must match the broker's setting
        self.spawn_timeout_s = spawn_timeout_s
        self.python = python
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(32)
        self._port = self._listener.getsockname()[1]
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._counter = 0
        self._closed = False
        self._pending: dict = {}   # worker_id -> (sock, pid) awaiting pickup
        self.spawned_total = 0
        # hellos are collected by a dedicated accept thread so concurrent
        # spawns overlap (worker cold-start is the dominant cost)
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True, name="fabric-accept")
        self._acceptor.start()

    # ------------------------------------------------------------ lifecycle
    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return   # listener closed
            conn.settimeout(self.spawn_timeout_s)
            try:
                hello, _ = recv_msg(conn)
            except (EOFError, OSError, WireError, socket.timeout):
                conn.close()
                continue
            if hello.get("op") != "hello":
                conn.close()
                continue
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._cond:
                self._pending[hello["worker_id"]] = (conn, int(hello["pid"]))
                self._cond.notify_all()

    def spawn(self) -> WorkerHandle:
        """Launch a fresh worker process and complete the hello handshake.
        Safe to call from several threads at once — cold-starts overlap."""
        with self._lock:
            if self._closed:
                raise SpawnError("pool closed")
            self._counter += 1
            wid = f"w{self._counter}"
        env = os.environ.copy()
        env[tasklib.WORKER_ENV] = wid
        path = env.get("PYTHONPATH", "")
        if _SRC_DIR not in path.split(os.pathsep):
            env["PYTHONPATH"] = (_SRC_DIR + os.pathsep + path) if path \
                else _SRC_DIR
        cmd = [self.python, "-m", "repro_torch.cloud.worker",
               "--connect", f"127.0.0.1:{self._port}",
               "--worker-id", wid,
               "--init", ",".join(self.init_modules),
               "--heartbeat", str(self.heartbeat_s)]
        if not self.dedup:
            cmd.append("--no-dedup")
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL)
        deadline = time.monotonic() + self.spawn_timeout_s
        with self._cond:
            while wid not in self._pending:
                if proc.poll() is not None:
                    raise SpawnError(f"worker {wid} exited "
                                     f"rc={proc.returncode} before connecting")
                if self._closed or time.monotonic() >= deadline:
                    proc.kill()
                    raise SpawnError(f"worker {wid} hello timed out")
                self._cond.wait(0.1)
            sock, pid = self._pending.pop(wid)
            self.spawned_total += 1
        return WorkerHandle(wid, proc, sock, pid)

    def register_metrics(self, registry):
        registry.gauge("pool.spawned_total", lambda: self.spawned_total)
        registry.gauge("pool.pending_hellos", lambda: len(self._pending))

    def kill(self, h: WorkerHandle, grace_s: float = 2.0):
        h.state = "dead"
        try:
            h.sock.close()
        except OSError:
            pass
        if h.proc.poll() is None:
            h.proc.terminate()
            try:
                h.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=grace_s)

    def close(self):
        with self._lock:
            self._closed = True
            try:
                self._listener.close()
            except OSError:
                pass
