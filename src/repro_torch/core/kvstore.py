"""Key-value store / pub-sub broker (a copy of ``repro/core/kvstore.py``;
paper component 5).

On the paper's CPU cluster this brokers parameter exchange between node
processes. Here parameters move as tensors on the device, but the host-level
orchestration (``runtime/executor.py``) still needs a broker for
*control-plane* state: round metadata, node stages (Alg. 1), the global
digests the ledger records. This in-process implementation keeps the
same publish/subscribe surface a distributed deployment (e.g. Redis) would.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable


class KVStore:
    """Thread-safe in-process key-value store with pub-sub callbacks."""
    def __init__(self):
        self._data: dict[str, Any] = {}
        self._subs: dict[str, list[Callable]] = collections.defaultdict(list)
        self._lock = threading.Lock()

    def publish(self, key: str, value: Any) -> None:
        """Set ``key`` and invoke its subscribers outside the lock."""
        with self._lock:
            self._data[key] = value
            subs = list(self._subs.get(key, ()))
        for fn in subs:
            fn(key, value)

    def get(self, key: str, default=None) -> Any:
        """Read ``key``, returning ``default`` when absent."""
        with self._lock:
            return self._data.get(key, default)

    def subscribe(self, key: str, fn: Callable) -> None:
        """Register ``fn(key, value)`` to run on every publish of ``key``."""
        with self._lock:
            self._subs[key].append(fn)

    def keys(self, prefix: str = "") -> list:
        """List stored keys, optionally filtered by ``prefix``."""
        with self._lock:
            return [k for k in self._data if k.startswith(prefix)]

    # -- Alg. 1 signal helpers -----------------------------------------
    def set_process_phase(self, phase: int) -> None:
        """Publish the global Alg. 1 process phase."""
        self.publish("process_phase", phase)

    def set_node_stage(self, node: str, stage: int) -> None:
        """Publish one node's Alg. 1 stage."""
        self.publish(f"node_stage/{node}", stage)

    def all_nodes_in_stage(self, nodes, stage: int) -> bool:
        """True when every listed node has reached ``stage``."""
        return all(self.get(f"node_stage/{n}") == stage for n in nodes)
