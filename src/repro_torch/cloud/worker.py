"""Fabric worker process: ``python -m repro_torch.cloud.worker --connect ...``.

Connects back to the broker, announces itself with a hello message, then
serves tasks one at a time over the socket:

  * ``task``  — resolve the step fn (registry name or pickled function),
    execute with decoded kwargs, reply ``result`` or ``error``;
  * ``ship``  — echo the payload back (the RPCTransport byte-movement
    primitive: the value really crosses the process boundary both ways —
    though with chunk dedup the echo direction is typically metadata-only,
    the broker having just sent those very chunks);
  * ``shutdown`` — exit cleanly.

The socket carries the content-addressed chunk stream (wire.py): unless
started with ``--no-dedup`` the worker keeps a :class:`ChannelStore`
mirroring the broker's, so repeated payload chunks (the same params in
every task's kwargs) arrive as digest references. Each reply also
carries ``req_recv_s`` (how long the request took to stream in) and
``work_s`` (execution time), letting the broker attribute the round
trip per direction — the feed for asymmetric-link bandwidth estimates.

A daemon thread emits heartbeats on an interval so the broker can tell a
hung or SIGKILLed worker from a slow one. Imports are numpy + stdlib
only; a pickled step that uses torch imports it lazily, but registry steps
keep worker cold-start in the ~100 ms range.
"""
from __future__ import annotations

import argparse
import importlib
import os
import pickle
import socket
import threading
import time
import traceback

from repro_torch.cloud import tasklib
from repro_torch.cloud.wire import (ChannelStore, WireError, recv_msg,
                                    send_msg)


def serve(host: str, port: int, worker_id: str, init_modules, heartbeat_s: float,
          dedup: bool = True):
    for mod in init_modules:
        if mod:
            importlib.import_module(mod)
    sock = socket.create_connection((host, port))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    store = ChannelStore() if dedup else None
    send_lock = threading.Lock()
    with send_lock:
        send_msg(sock, {"op": "hello", "worker_id": worker_id,
                        "pid": os.getpid()}, store)

    stop = threading.Event()

    def heartbeats():
        while not stop.wait(heartbeat_s):
            try:
                with send_lock:
                    send_msg(sock, {"op": "heartbeat",
                                    "worker_id": worker_id}, store)
            except OSError:
                return

    threading.Thread(target=heartbeats, daemon=True).start()

    try:
        while True:
            stats: dict = {}
            try:
                msg, _ = recv_msg(sock, store, stats=stats)
            except (EOFError, OSError, WireError):
                # WireError: corrupted frame / desynced stores — the
                # stream is unrecoverable; exiting lets the broker's
                # death path requeue the in-flight task cleanly
                break
            op = msg.get("op")
            if op == "shutdown":
                break
            t0 = time.perf_counter()
            if op == "ship":
                reply = {"op": "result", "task_id": msg["task_id"],
                         "value": msg.get("value")}
            elif op == "task":
                reply = _run_task(msg)
            else:
                reply = {"op": "error", "task_id": msg.get("task_id", -1),
                         "error": f"unknown op {op!r}"}
            reply["req_recv_s"] = stats.get("recv_s", 0.0)
            reply["work_s"] = time.perf_counter() - t0
            if msg.get("trace") is not None:
                # span context arrived in the task frame header: report
                # this task's phases as (wall t0, duration) dicts — the
                # broker re-materialises them as child spans of the
                # driver-side span identified by msg["trace"]. Wall clock
                # on purpose: it is the one clock both processes share.
                wall1 = time.time()
                work_s = reply["work_s"]
                recv_s = reply["req_recv_s"]
                reply["trace"] = msg["trace"]
                reply["spans"] = [
                    {"name": "recv", "t0": wall1 - work_s - recv_s,
                     "dur": recv_s},
                    {"name": "exec", "t0": wall1 - work_s, "dur": work_s},
                ]
            try:
                with send_lock:
                    send_msg(sock, reply, store)
            except OSError:
                break
    finally:
        stop.set()
        sock.close()


def _run_task(msg) -> dict:
    task_id = msg["task_id"]
    try:
        if msg.get("step"):
            fn = tasklib.resolve(msg["step"])
        else:
            fn = pickle.loads(msg["fn"])
        out = fn(**(msg.get("kwargs") or {}))
        return {"op": "result", "task_id": task_id, "value": out}
    except BaseException as e:  # report everything short of os._exit
        return {"op": "error", "task_id": task_id, "error": repr(e),
                "traceback": traceback.format_exc()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--connect", required=True, help="broker host:port")
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--init", default="repro_torch.cloud.tasklib",
                    help="comma-separated modules to import at startup")
    ap.add_argument("--heartbeat", type=float, default=0.25)
    ap.add_argument("--no-dedup", action="store_true",
                    help="disable chunk dedup (must match the broker)")
    args = ap.parse_args(argv)
    host, port = args.connect.rsplit(":", 1)
    serve(host, int(port), args.worker_id, args.init.split(","),
          args.heartbeat, dedup=not args.no_dedup)


if __name__ == "__main__":
    main()
