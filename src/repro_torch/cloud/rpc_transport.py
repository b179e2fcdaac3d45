"""MDSS transport that ships bytes through the offload fabric.

The port of ``repro.cloud.rpc_transport``. When either endpoint tier is
fabric-backed (``tier.worker_pool`` set), the value is wire-encoded,
round-tripped through a worker process, and decoded — so ``ensure`` /
``stale_bytes`` accounting reflects bytes that genuinely crossed an OS
process boundary. The worker's reply is numpy (workers hold no torch):
each leaf that left as a tensor is rebuilt as a tensor of its dtype on
the destination tier's device, so a staged value is what a step on that
tier expects, bit for bit.

Content addressing (``transfer_ex``): MDSS hands over the value's chunk
manifest and how many of those bytes are *not* already resident at the
destination tier. A fully-resident value ships as a **metadata-only
round trip** (just the digests cross the fabric); anything else ships
the value, where the socket-level chunk stores (wire.py) independently
dedup whatever previously crossed that worker's connection. The
returned byte count is the dedup-aware obligation MDSS accounts.

Each ship also yields bandwidth samples fed into
``CostModel.observe_bandwidth``. Workers report how long the request
took to stream in (``req_recv_s``) and how long they computed, so large
ships produce **per-direction** samples — ``(src, dst)`` from the
request leg, ``(dst, src)`` from the reply leg — letting the locality
scorer track asymmetric up/down links; small ships fall back to one
combined sample (a tiny frame measures latency, not bandwidth).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.core.mdss import Transport, nbytes_of

# below this, a leg's timing is latency-dominated: keep feeding the
# combined round-trip sample instead of two noisy directional ones
DIRECTIONAL_MIN_BYTES = 1 << 16


def _rebuild(got, like, device):
    """The worker's numpy reply, with each leaf that was a tensor in
    ``like`` (the value that was shipped) rebuilt as a tensor of that
    dtype on ``device``; other leaves stay as they came back."""
    def leaf(g, orig):
        if not isinstance(orig, torch.Tensor):
            return g
        a = np.asarray(g).view(np.ndarray)   # decoded: contiguous, writable
        if orig.dtype == torch.bfloat16:     # came back as its 16-bit pattern
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device if device is not None else orig.device)
    return tree_map(leaf, got, like)


class RPCTransport(Transport):
    def __init__(self, fabric, tiers=None, cost_model=None,
                 ship_timeout_s: float = 60.0):
        super().__init__(tiers)
        self.fabric = fabric
        self.cost_model = cost_model
        self.ship_timeout_s = ship_timeout_s
        # MDSS calls transfer() with no lock held (transfers overlap
        # compute), so the accounting needs its own
        self._lock = threading.Lock()
        self.bytes_shipped: Dict[Tuple[str, str], int] = {}
        self.ship_events: list = []
        self.metadata_only_ships = 0

    def _fabric_backed(self, name: str) -> bool:
        tier = self.tiers.get(name)
        return tier is not None and getattr(tier, "worker_pool", None) is not None

    def transfer(self, value, src: str, dst: str):
        return self.transfer_ex(value, src, dst)[0]

    def transfer_ex(self, value, src: str, dst: str, chunks=None,
                    missing_bytes: Optional[int] = None):
        """Move ``value`` src->dst; returns ``(value, owed_bytes)`` where
        ``owed_bytes`` is the dedup-aware transfer obligation MDSS
        accounts (0 for a metadata-only round trip)."""
        logical = nbytes_of(value)
        owed = logical if missing_bytes is None else missing_bytes
        if not (self._fabric_backed(src) or self._fabric_backed(dst)):
            return super().transfer(value, src, dst), owed
        if chunks is not None and missing_bytes == 0:
            # every chunk already resident at dst: offer digests only —
            # the warm-params staging path collapses to metadata
            task = self.fabric.ship({"digests": [d for d, _ in chunks]},
                                    timeout=self.ship_timeout_s)
            # the driver's own value, placed on dst's device
            out, observe = super().transfer(value, src, dst), False
        else:
            task = self.fabric.ship(value, timeout=self.ship_timeout_s)
            tier = self.tiers.get(dst)
            out = _rebuild(task.value, value,
                           tier.device if tier is not None else None)
            observe = True
        key = (src, dst)
        with self._lock:
            self.bytes_shipped[key] = self.bytes_shipped.get(key, 0) \
                + task.bytes_sent
            self.ship_events.append((src, dst, task.bytes_sent, task.seconds))
            if not observe:
                self.metadata_only_ships += 1
            elif self.cost_model is not None:
                directional = False
                if task.up_s > 0 and task.bytes_sent >= DIRECTIONAL_MIN_BYTES:
                    self.cost_model.observe_bandwidth(
                        src, dst, task.bytes_sent, task.up_s)
                    directional = True
                if task.down_s > 0 and \
                        task.bytes_received >= DIRECTIONAL_MIN_BYTES:
                    self.cost_model.observe_bandwidth(
                        dst, src, task.bytes_received, task.down_s)
                    directional = True
                wire_total = task.bytes_sent + task.bytes_received
                if not directional and task.seconds > 0 \
                        and wire_total >= logical:
                    # combined round-trip sample — but only when the
                    # payload genuinely crossed: a dedup-shrunken ship
                    # (refs instead of bytes) measures latency, not
                    # bandwidth, and would poison the EMA
                    self.cost_model.observe_bandwidth(
                        src, dst, wire_total, task.seconds)
        return out, owed

    def total_bytes_shipped(self) -> int:
        with self._lock:
            return sum(self.bytes_shipped.values())
