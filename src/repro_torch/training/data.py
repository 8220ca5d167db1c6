"""Data pipeline: deterministic, checkpointable, host-sharded.

Two sources behind one iterator protocol (``next() -> batch dict``,
``state() -> dict``, ``restore(state)``):

  * ``SyntheticLM`` — counter-based PRNG stream (stateless hash of
    (seed, step, host)); exact resume = restoring an integer.  Markov-chain
    token transitions so the loss has learnable structure.
  * ``MemmapCorpus`` — tokenized corpus in a flat .bin memmap; shuffled
    window sampling keyed by (seed, step) — same exact-resume property.

Per-host sharding: each host draws only its slice of the global batch
(``host_batch = global_batch // num_hosts``); restore works across a
*different* host count because the stream is keyed by the global step.
A background prefetch thread keeps one batch ahead.

This is the JAX package's numpy pipeline, copied: its batches are the
reference's bit for bit (numpy int32 arrays on the host).  The training
loop (``launch/train.py``) moves each batch to the device once per step.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


# ---------------------------------------------------------------------------
# synthetic LM stream
# ---------------------------------------------------------------------------
class SyntheticLM:
    """Markov-chain token stream; batch ~ (host_batch, seq+1) -> tokens/labels."""

    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int,
                 seed: int = 0, host_index: int = 0, num_hosts: int = 1):
        assert global_batch % num_hosts == 0
        self.cfg = cfg
        self.seq_len = seq_len
        self.host_batch = global_batch // num_hosts
        self.seed = seed
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.step = 0
        V = cfg.vocab_size
        # fixed sparse transition structure (derived from seed only)
        rs = np.random.RandomState(seed)
        self._next_tok = rs.randint(0, V, size=(V, 4)).astype(np.int64)

    def _rng(self, step: int) -> np.random.RandomState:
        key = (self.seed * 1_000_003 + step) * 97 + self.host_index
        return np.random.RandomState(key % (2**31 - 1))

    def __next__(self) -> Dict[str, np.ndarray]:
        rs = self._rng(self.step)
        B, S, V = self.host_batch, self.seq_len, self.cfg.vocab_size
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rs.randint(0, V, size=B)
        choices = rs.randint(0, 4, size=(B, S))
        noise = rs.rand(B, S) < 0.1
        rand_toks = rs.randint(0, V, size=(B, S))
        for t in range(S):
            nxt = self._next_tok[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_toks[:, t], nxt)
        self.step += 1
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def state(self) -> Dict:
        return {"kind": "synthetic", "step": self.step, "seed": self.seed}

    def restore(self, st: Dict) -> None:
        assert st["kind"] == "synthetic"
        self.step = int(st["step"])
        self.seed = int(st["seed"])


# ---------------------------------------------------------------------------
# memmap corpus
# ---------------------------------------------------------------------------
class MemmapCorpus:
    """Flat int32 token file; samples random windows keyed by (seed, step)."""

    def __init__(self, path: str, cfg: ModelConfig, seq_len: int,
                 global_batch: int, seed: int = 0, host_index: int = 0,
                 num_hosts: int = 1):
        assert global_batch % num_hosts == 0
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg = cfg
        self.seq_len = seq_len
        self.host_batch = global_batch // num_hosts
        self.seed = seed
        self.host_index = host_index
        self.step = 0
        self.path = path
        if len(self.tokens) < seq_len + 2:
            raise ValueError("corpus shorter than one sequence")

    def __next__(self) -> Dict[str, np.ndarray]:
        key = (self.seed * 1_000_003 + self.step) * 97 + self.host_index
        rs = np.random.RandomState(key % (2**31 - 1))
        B, S = self.host_batch, self.seq_len
        starts = rs.randint(0, len(self.tokens) - S - 1, size=B)
        rows = np.stack([self.tokens[s:s + S + 1] for s in starts])
        self.step += 1
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def state(self) -> Dict:
        return {"kind": "memmap", "step": self.step, "seed": self.seed,
                "path": self.path}

    def restore(self, st: Dict) -> None:
        self.step = int(st["step"])
        self.seed = int(st["seed"])


# ---------------------------------------------------------------------------
# prefetcher
# ---------------------------------------------------------------------------
class Prefetcher:
    """One-batch-ahead background prefetch; state delegates to the source.

    Checkpoint correctness: ``state()`` reports the number of batches the
    *consumer* has taken (source step minus what's still buffered), so
    save+restore never drops or replays a batch.
    """

    def __init__(self, source, depth: int = 2):
        self.source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._taken = 0
        self._lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop:
            try:
                item = next(self.source)
            except StopIteration:  # pragma: no cover
                self._q.put(None)
                return
            self._q.put(item)

    def __next__(self):
        item = self._q.get()
        if item is None:  # pragma: no cover
            raise StopIteration
        with self._lock:
            self._taken += 1
        return item

    def state(self) -> Dict:
        st = self.source.state()
        st = dict(st)
        st["step"] = self._taken
        return st

    def close(self):
        self._stop = True

    def restore(self, st: Dict) -> None:  # pragma: no cover
        self.source.restore(st)
        with self._lock:
            self._taken = int(st["step"])


def make_pipeline(cfg: ModelConfig, seq_len: int, global_batch: int, *,
                  corpus_path: Optional[str] = None, seed: int = 0,
                  host_index: int = 0, num_hosts: int = 1,
                  prefetch: bool = False):
    if corpus_path:
        src = MemmapCorpus(corpus_path, cfg, seq_len, global_batch,
                           seed=seed, host_index=host_index,
                           num_hosts=num_hosts)
    else:
        src = SyntheticLM(cfg, seq_len, global_batch, seed=seed,
                          host_index=host_index, num_hosts=num_hosts)
    return Prefetcher(src) if prefetch else src
