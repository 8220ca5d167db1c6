"""Live terminal run dashboard over the metrics bus (DESIGN.md §11.4).

A plain-ANSI, dependency-free view of a running scenario: one row per
active tenant with interval rate, p99 sojourn, live scheduler weight,
admission state and burn-rate alert markers, plus the engine-global
Jain index.  Attach with ``--dash`` on ``repro_torch.launch.scenario``.

The dashboard is a bus *sink* (synchronous ``on_frame``), but all
drawing goes through the pure ``render(frame) -> str`` so CI can smoke
one headless frame without a tty:

    PYTHONPATH=src python -m repro_torch.launch.dash --headless
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np

from repro_torch.telemetry.metrics import C_IDX

CLEAR = "\x1b[2J\x1b[H"
BOLD = "\x1b[1m"
RED = "\x1b[31m"
YELLOW = "\x1b[33m"
RESET = "\x1b[0m"

_HEADER = ("tenant", "rate/int", "p99", "weight", "admit", "burn",
           "alerts")
_WIDTHS = (12, 9, 12, 7, 6, 5, 7)


def _row(cells) -> str:
    return "  ".join(str(c).ljust(w) for c, w in zip(cells, _WIDTHS))


class Dashboard:
    """Bus sink rendering a refreshing status panel."""

    def __init__(self, *, names: Optional[Dict[int, str]] = None,
                 out=None, color: Optional[bool] = None,
                 refresh_every: int = 1):
        self.names = names or {}
        self.out = out if out is not None else sys.stdout
        isatty = bool(getattr(self.out, "isatty", lambda: False)())
        self.color = isatty if color is None else color
        self.refresh_every = max(1, int(refresh_every))
        self.frames = 0
        self._alert_totals: Dict[int, int] = {}
        self._alert_seen: Dict[int, str] = {}   # tenant -> last window kind

    # -- pure rendering ------------------------------------------------------
    def render(self, frame) -> str:
        """One full panel for ``frame`` (no escape codes unless color)."""
        sig = frame.signals
        active = np.nonzero(frame.counts.sum(axis=1) > 0)[0]
        lines = []
        c = (lambda code, s: f"{code}{s}{RESET}") if self.color \
            else (lambda code, s: s)
        lines.append(c(BOLD,
                       f"OSMOSIS live  backend={frame.backend}  "
                       f"t={frame.t:g} {frame.time_unit}  "
                       f"frame={frame.seq}"))
        lines.append(_row(_HEADER))
        for i in active:
            i = int(i)
            name = self.names.get(i, f"tenant{i}")
            rate = int(frame.interval_counts[i, C_IDX["completed"]])
            p99 = sig.p99[i]
            mark = self._alert_seen.get(i, "")
            burn = {"fast": "!F", "slow": "!S"}.get(mark, "-")
            row = _row((name[:_WIDTHS[0]], rate, f"{p99:g}",
                        f"{frame.weights[i]:.3g}",
                        "yes" if frame.admit[i] else "NO",
                        burn, self._alert_totals.get(i, 0)))
            if mark:
                row = c(RED, row)
            elif not frame.admit[i]:
                row = c(YELLOW, row)
            lines.append(row)
        lines.append(f"jain={sig.jain_weighted:.4f}  "
                     f"alerts_total={sum(self._alert_totals.values())}")
        for a in frame.alerts:
            lines.append(c(RED,
                           f"  ALERT {self.names.get(a.tenant, a.tenant)}: "
                           f"{a.window} burn={a.burn_rate:.3g} "
                           f"p99={a.p99:g} > target={a.target:g}"))
        return "\n".join(lines) + "\n"

    # -- bus sink ------------------------------------------------------------
    def on_frame(self, frame) -> None:
        for a in frame.alerts:
            self._alert_totals[a.tenant] = \
                self._alert_totals.get(a.tenant, 0) + 1
            self._alert_seen[a.tenant] = a.window
        self.frames += 1
        if self.frames % self.refresh_every:
            return
        text = self.render(frame)
        if self.color:
            self.out.write(CLEAR)
        self.out.write(text)
        self.out.flush()

    def close(self) -> None:
        pass


def demo_frame():
    """A small synthetic BusFrame for the headless CI smoke."""
    from repro_torch.telemetry.bus import BusFrame
    from repro_torch.telemetry.metrics import COUNTERS
    from repro_torch.telemetry.signals import SignalFrame
    from repro_torch.telemetry.slo_audit import SLOAlert
    T = 2
    counts = np.zeros((T, len(COUNTERS)), np.int64)
    counts[:, C_IDX["arrivals"]] = (40, 28)
    counts[:, C_IDX["completed"]] = (40, 9)
    z = np.zeros(T)
    sig = SignalFrame(p50=np.array([900.0, 5200.0]),
                      p99=np.array([1800.0, 9800.0]),
                      ecn_rate=z, drop_rate=z, service_debt=z,
                      kv_pressure=z, occupancy_mean=np.array([0.7, 0.2]),
                      queue_mean=np.array([1.0, 6.0]),
                      jain_weighted=0.8123,
                      lat_samples=np.array([40.0, 9.0]))
    alert = SLOAlert(t=4000.0, tenant=1, window="fast", burn_rate=10.0,
                     p99=9800.0, target=4000.0)
    return BusFrame(t=4000.0, seq=1, time_unit="ns", backend="sim",
                    signals=sig, counts=counts,
                    interval_counts=counts.copy(),
                    weights=np.array([1.0, 2.0]),
                    admit=np.array([True, True]), alerts=(alert,))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="headless dashboard smoke")
    ap.add_argument("--headless", action="store_true",
                    help="render one synthetic frame and exit")
    args = ap.parse_args(argv)
    if not args.headless:
        ap.error("interactive mode runs via repro_torch.launch.scenario --dash; "
                 "use --headless here")
    dash = Dashboard(names={0: "aggressor", 1: "victim"}, color=False)
    dash.on_frame(demo_frame())
    return 0


if __name__ == "__main__":
    sys.exit(main())
