"""The executor's calls as CUDA graphs (``EngineConfig.cuda_graphs``).

An eager call enqueues every operation of every layer from Python, and
a served step then lasts as long as the host takes to enqueue it: for
DeepSeek-V2-Lite a decode call is a few thousand launches over ~40 ms of
device work.  A graph enqueues the same operations in one launch.

``CallGraphs`` captures, once, when the executor is built: the decode
call at its one shape (``max_slots`` rows) and ``prefill_rows`` at each
number of rows k from 1 to ``prefill_slots_per_step`` (the most the
engine grants a step).  Each graph reads its inputs from static device
buffers, which a replay fills from the host arrays first, and writes the
cache in place, as the eager call does: the cache's tensors are the
executor's own, so eager calls and replays can follow one another.  A
call of another shape (the whole chunk, more rows than the engine
grants) runs eagerly.

What a graph may hold is what the served functions already are on one
device: no host sync, no host branch on a device value, no copy from
pageable memory (``models/moe.py``'s ``grouped`` dispatch and MLA keep
to that).  A model whose calls break it fails at capture, when the
executor is built, not while serving.  Capture runs each call twice on
the cache, which the executor then resets (every slot free), as it is
when built.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch


class CallGraphs:
    """Graphs of ``fns.decode`` and ``fns.prefill_rows`` over ``cache``
    (the executor's), on ``device`` (a CUDA device)."""

    def __init__(self, fns, params, cache, *, batch: int, chunk: int,
                 max_rows: int):
        dev = fns.device
        self._pool = torch.cuda.graph_pool_handle()
        i32 = dict(dtype=torch.int32, device=dev)
        self._decode_in = (torch.ones(batch, **i32),
                           torch.full((batch,), chunk, **i32),
                           torch.ones(batch, dtype=torch.bool, device=dev))
        self._decode_g, self._decode_out = self._capture(
            fns.decode, params, cache, self._decode_in)
        self._chunk = chunk
        self._rows: Dict[int, Tuple] = {}
        if fns.prefill_rows is None:
            return
        for k in range(1, min(max_rows, batch - 1) + 1):
            args = (torch.arange(k, dtype=torch.int64, device=dev),
                    torch.ones((batch, chunk), **i32),
                    torch.zeros(batch, **i32),
                    torch.full((batch,), chunk, **i32))
            g, out = self._capture(fns.prefill_rows, params, cache, args)
            self._rows[k] = (g, args, out)

    def _capture(self, fn: Callable, params, cache, args):
        """One eager run on a side stream (the allocator's and the
        libraries' first-call work), then the capture.  Returns (graph,
        the call's sampled tokens, a static tensor).  The graphs share one
        memory pool, so a replay may overwrite another graph's output:
        each is read back before the next replay."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(params, cache, *args)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self._pool):
            nxt = fn(params, cache, *args)[0]
        return g, nxt

    @staticmethod
    def _fill(static, arrays) -> None:
        for t, a in zip(static, arrays):
            t.copy_(torch.from_numpy(np.asarray(a)))

    def decode(self, tokens, lengths, active) -> torch.Tensor:
        """The decode call replayed on these host arrays: (B,) tokens on
        the device (the graph's static output)."""
        self._fill(self._decode_in, (tokens, lengths, active))
        self._decode_g.replay()
        return self._decode_out

    def has_rows(self, k: int, chunk: int) -> bool:
        return k in self._rows and chunk == self._chunk

    def prefill_rows(self, rows, tokens, lengths, valid_n) -> torch.Tensor:
        """``prefill_rows`` replayed for the ``len(rows)`` slots ``rows``:
        (k,) tokens on the device."""
        g, static, nxt = self._rows[len(rows)]
        self._fill(static, (rows, tokens, lengths, valid_n))
        g.replay()
        return nxt
