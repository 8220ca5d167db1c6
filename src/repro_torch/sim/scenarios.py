"""Scenario entry points that return the simulator's native ``SimResult``
— thin shims over the runtime API.

Every scenario here is a registered declarative ``ScenarioSpec`` in
``repro_torch.api.scenarios``; these functions build the spec and run it
through ``SimRuntime``, returning the ``SimResult`` (per-tenant
statistics, completions, telemetry) that the golden tests read.  New
code should use the API directly:

    from repro_torch.api import get_scenario, run_scenario
    report = run_scenario(get_scenario("fig9_congestor_victim"), "sim")

or the CLI: ``python -m repro_torch.launch.scenario <name> --backend sim``.
``service_time_vs_ppb`` is the analytic Fig. 3 table
(``ppb_service_time``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.configs.osmosis_pspin import PSPIN
from repro_torch.core import ECTX, FragmentationPolicy, SLOPolicy
from repro_torch.sim.engine import SimResult
from repro_torch.sim.workloads import WORKLOADS, WorkloadModel, ppb


def make_tenants(kernels: List[WorkloadModel],
                 priorities: Optional[List[float]] = None,
                 cycle_limits: Optional[List[int]] = None) -> List[ECTX]:
    out = []
    for i, k in enumerate(kernels):
        slo = SLOPolicy(
            priority=(priorities[i] if priorities else 1.0),
            kernel_cycle_limit=(cycle_limits[i] if cycle_limits else 0))
        out.append(ECTX(tenant_id=i, name=k.name, slo=slo, kernel=k))
    return out


def _run_sim(spec) -> SimResult:
    """Run a spec on the sim backend, returning its SimResult."""
    from repro_torch.api.runtime import SimRuntime
    rt = SimRuntime.from_spec(spec)
    rt.run(spec)
    return rt.result


def run_congestor_victim_compute(scheduler: str, *, cpb_victim: float = 0.6,
                                 cpb_ratio: float = 2.0,
                                 duration_us: float = 300.0,
                                 pkt_size: int = 512, seed: int = 0
                                 ) -> SimResult:
    """Paper Figs. 4 & 9 (shim over ``fig9_congestor_victim``)."""
    from repro_torch.api import get_scenario
    return _run_sim(get_scenario(
        "fig9_congestor_victim", scheduler=scheduler, cpb_victim=cpb_victim,
        cpb_ratio=cpb_ratio, duration_us=duration_us, pkt_size=pkt_size,
        seed=seed))


def run_hol_blocking(frag: FragmentationPolicy, *, congestor_size: int = 4096,
                     victim_size: int = 64, duration_us: float = 150.0,
                     scheduler: str = "wlbvt", arb: str = "dwrr",
                     seed: int = 0) -> SimResult:
    """Paper Figs. 5 & 10 (shim over ``fig10_hol_blocking``)."""
    from repro_torch.api import get_scenario
    return _run_sim(get_scenario(
        "fig10_hol_blocking", frag_mode=frag.mode,
        frag_bytes=frag.fragment_bytes, congestor_size=congestor_size,
        victim_size=victim_size, duration_us=duration_us,
        scheduler=scheduler, arb=arb, seed=seed))


def run_standalone(workload_name: str, *, pkt_size: int,
                   duration_us: float = 100.0,
                   osmosis: bool = True, seed: int = 0) -> SimResult:
    """Paper Fig. 11 (shim over ``fig11_standalone``)."""
    from repro_torch.api import get_scenario
    return _run_sim(get_scenario(
        "fig11_standalone", workload=workload_name, pkt_size=pkt_size,
        duration_us=duration_us, osmosis=osmosis, seed=seed))


def run_qos_closed_loop(controller: bool = True, *,
                        p99_target_ns: float = 2000.0,
                        duration_us: float = 300.0,
                        control_interval_ns: float = 8000.0,
                        seed: int = 0) -> SimResult:
    """Closed-loop QoS, DESIGN.md §6 (shim over ``qos_closed_loop``)."""
    from repro_torch.api import get_scenario
    return _run_sim(get_scenario(
        "qos_closed_loop", controller=controller,
        p99_target_ns=p99_target_ns, duration_us=duration_us,
        control_interval_ns=control_interval_ns, seed=seed))


def run_compute_mixture(scheduler: str, *, duration_us: float = 200.0,
                        seed: int = 0) -> SimResult:
    """Paper Fig. 12 (shim over ``fig12_compute_mixture``)."""
    from repro_torch.api import get_scenario
    return _run_sim(get_scenario(
        "fig12_compute_mixture", scheduler=scheduler,
        duration_us=duration_us, seed=seed))


def run_io_mixture(scheduler: str, *, frag: Optional[FragmentationPolicy]
                   = None, duration_us: float = 200.0,
                   seed: int = 0) -> SimResult:
    """Paper Figs. 13/14 (shim over ``fig13_io_mixture``)."""
    from repro_torch.api import get_scenario
    kw = {}
    if frag is not None:
        kw = {"frag_mode": frag.mode, "frag_bytes": frag.fragment_bytes}
    return _run_sim(get_scenario(
        "fig13_io_mixture", scheduler=scheduler, duration_us=duration_us,
        seed=seed, **kw))


def service_time_vs_ppb(pkt_sizes: List[int]) -> Dict[str, List[Tuple[int, float, float]]]:
    """Paper Fig. 3: per-workload single-packet service time vs PPB
    (analytic; also exposed as the ``ppb_service_time`` scenario)."""
    out: Dict[str, List[Tuple[int, float, float]]] = {}
    for name, wl in WORKLOADS.items():
        rows = []
        for p in pkt_sizes:
            payload = max(0, p - PSPIN.header_bytes)
            service = wl.compute_cycles(payload)
            if wl.io_kind != "none":
                service += wl.io_bytes(payload) * PSPIN.wire_ns_per_byte(
                    PSPIN.axi_gbps)
            budget = ppb(PSPIN.num_pus, p, PSPIN.ingress_gbps)
            rows.append((p, service, budget))
        out[name] = rows
    return out
