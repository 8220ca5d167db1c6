"""Built-in scenario catalog: the paper's simulator scenarios (Figs. 3,
9-13 and the closed-loop QoS scenario) and the serving-native scenarios,
as registered declarative ``ScenarioSpec`` factories.

The sweep datapath runs the simulator scenarios that fit its contract
(``sim.devicepath.device_eligible``; ``launch/sweep.py``):

    PYTHONPATH=src python -m repro_torch.launch.sweep fig9_congestor_victim \
        --axis scheduler='"wlbvt","rr"' --seeds 8 --device cpu

Every other spec given to it raises ``DevicePathError`` with the reason.
Every scenario runs on the host simulators and the serving engine
through ``launch/scenario.py`` (``run_scenario``).  The fleet plane's
multi-NIC scenarios (``fleet/scenarios.py``) are registered from the
end of this module and run on the host fleet engine; the sweep takes
only their single-NIC twins (``FleetSpec.plain()``).
"""
from __future__ import annotations

from repro_torch.api.registry import register_scenario
from repro_torch.api.spec import (ArrivalSpec, ControllerSpec,
                                  ScenarioSpec, ServeSpec, TenantSpec,
                                  WorkloadSpec)


def _spin(name: str, cpb: float, base: float = 40.0) -> WorkloadSpec:
    return WorkloadSpec(name=name, compute_base=base, compute_per_byte=cpb)


# ---------------------------------------------------------------------------
# paper scenarios (cycle simulator; two also project onto serving)
# ---------------------------------------------------------------------------
@register_scenario("fig9_congestor_victim")
def fig9_congestor_victim(scheduler: str = "wlbvt", *,
                          cpb_victim: float = 0.6, cpb_ratio: float = 2.0,
                          duration_us: float = 300.0, pkt_size: int = 512,
                          seed: int = 0) -> ScenarioSpec:
    """Paper Figs. 4 & 9: two compute-bound spin tenants, the congestor
    ``cpb_ratio``x the compute cost per byte.  Serving projection: the
    congestor's requests carry 4x the work (long prompts + outputs)."""
    return ScenarioSpec(
        name="fig9_congestor_victim",
        description="PU fairness: 2x-costlier congestor vs victim "
                    "(paper Figs. 4/9)",
        backends=("sim", "serve"),
        tenants=(
            TenantSpec("congestor",
                       workload=_spin("congestor", cpb_victim * cpb_ratio),
                       arrival=ArrivalSpec(size=pkt_size, share=0.5,
                                           requests=24, prompt_len=160,
                                           max_new_tokens=48)),
            TenantSpec("victim", workload=_spin("victim", cpb_victim),
                       arrival=ArrivalSpec(size=pkt_size, share=0.5,
                                           requests=24, prompt_len=16,
                                           max_new_tokens=16)),
        ),
        scheduler=scheduler, duration_us=duration_us, seed=seed,
        record_timeline=True,
        serve=ServeSpec(max_slots=8, max_len=256, prefill_chunk=32,
                        kv_overcommit=2.0))


@register_scenario("fig10_hol_blocking")
def fig10_hol_blocking(*, frag_mode: str = "hardware", frag_bytes: int = 512,
                       congestor_size: int = 4096, victim_size: int = 64,
                       duration_us: float = 150.0, scheduler: str = "wlbvt",
                       arb: str = "dwrr", seed: int = 0) -> ScenarioSpec:
    """Paper Figs. 5 & 10: small request packets trigger large blocking
    egress transfers; fragmentation bounds the victim's HoL wait."""
    return ScenarioSpec(
        name="fig10_hol_blocking",
        description="HoL blocking: 64B victim vs 4KiB egress congestor "
                    "(paper Figs. 5/10)",
        tenants=(
            TenantSpec("congestor_io",
                       workload=WorkloadSpec(name="congestor_io",
                                             compute_base=40,
                                             compute_per_byte=0.02,
                                             io_kind="egress",
                                             io_fixed_bytes=congestor_size),
                       arrival=ArrivalSpec(size=512, share=0.50)),
            TenantSpec("victim_io",
                       workload=WorkloadSpec(name="victim_io",
                                             compute_base=40,
                                             compute_per_byte=0.02,
                                             io_kind="egress",
                                             io_fixed_bytes=victim_size),
                       arrival=ArrivalSpec(size=64, share=0.02,
                                           seed_offset=1)),
        ),
        scheduler=scheduler, arbiter=arb, frag_mode=frag_mode,
        frag_bytes=frag_bytes, duration_us=duration_us, seed=seed)


@register_scenario("fig11_standalone")
def fig11_standalone(*, workload: str = "aggregate", pkt_size: int = 1024,
                     duration_us: float = 100.0, osmosis: bool = True,
                     seed: int = 0) -> ScenarioSpec:
    """Paper Fig. 11: single tenant, OSMOSIS (WLBVT + hw frag + DWRR) vs
    the reference PsPIN (RR, FIFO bus, no fragmentation)."""
    return ScenarioSpec(
        name="fig11_standalone",
        description="single-tenant overhead: OSMOSIS vs reference PsPIN "
                    "(paper Fig. 11)",
        tenants=(TenantSpec(workload,
                            workload=WorkloadSpec(ref=workload),
                            arrival=ArrivalSpec(size=pkt_size, share=1.0)),),
        scheduler="wlbvt" if osmosis else "rr",
        arbiter="dwrr" if osmosis else "fifo",
        frag_mode="hardware" if osmosis else "off", frag_bytes=512,
        duration_us=duration_us, seed=seed)


@register_scenario("fig12_compute_mixture")
def fig12_compute_mixture(scheduler: str = "wlbvt", *,
                          duration_us: float = 200.0,
                          seed: int = 0) -> ScenarioSpec:
    """Paper Fig. 12: Reduce + Histogram, each as victim (small packets)
    and congestor (multi-KiB packets), in the burst-saturation regime."""
    names = ("reduce_victim", "reduce_congestor", "hist_victim",
             "hist_congestor")
    refs = ("reduce", "reduce", "histogram", "histogram")
    sizes = (64, 4096, 96, 3584)
    shares = (0.30, 0.35, 0.30, 0.35)
    return ScenarioSpec(
        name="fig12_compute_mixture",
        description="compute-bound mixture: Reduce+Histogram x "
                    "victim/congestor (paper Fig. 12)",
        tenants=tuple(
            TenantSpec(names[i], workload=WorkloadSpec(ref=refs[i]),
                       arrival=ArrivalSpec(size=sizes[i], share=shares[i],
                                           seed_offset=i))
            for i in range(4)),
        scheduler=scheduler, frag_mode="hardware", frag_bytes=512,
        fifo_capacity=1 << 17, record_timeline=True,
        duration_us=duration_us, seed=seed)


@register_scenario("fig13_io_mixture")
def fig13_io_mixture(scheduler: str = "wlbvt", *, frag_mode: str = "",
                     frag_bytes: int = 1024, duration_us: float = 200.0,
                     seed: int = 0) -> ScenarioSpec:
    """Paper Figs. 13/14: storage data-path offload mixture — 64B DMA
    victims vs storage-RPC congestors (512B request -> 4KiB DMA), with
    combined AXI demand ~1.1x the bus.  ``frag_mode=""`` auto-selects
    the policy the compared system would use (OSMOSIS: hardware/1024B;
    reference: off)."""
    osmosis = scheduler == "wlbvt"
    if not frag_mode:
        frag_mode = "hardware" if osmosis else "off"
    names = ("read_victim", "read_congestor", "write_victim",
             "write_congestor")
    kinds = ("dma_read", "dma_read", "dma_write", "dma_write")
    io_bytes = (64, 4096, 64, 4096)
    sizes = (64, 512, 64, 512)
    durs = (0.6, 1.0, 0.6, 1.0)
    return ScenarioSpec(
        name="fig13_io_mixture",
        description="IO-bound mixture: DMA read/write x victim/congestor "
                    "(paper Figs. 13/14)",
        tenants=tuple(
            TenantSpec(names[i],
                       workload=WorkloadSpec(name=names[i], compute_base=40,
                                             compute_per_byte=0.02,
                                             io_kind=kinds[i],
                                             io_fixed_bytes=io_bytes[i]),
                       arrival=ArrivalSpec(size=sizes[i], share=0.10,
                                           duration_frac=durs[i],
                                           seed_offset=i))
            for i in range(4)),
        scheduler=scheduler, arbiter="dwrr" if osmosis else "fifo",
        frag_mode=frag_mode, frag_bytes=frag_bytes,
        io_demand_weights="demand", fifo_capacity=1 << 15,
        record_timeline=True, duration_us=duration_us, seed=seed)


@register_scenario("qos_closed_loop")
def qos_closed_loop(controller: bool = True, *,
                    p99_target_ns: float = 2000.0,
                    duration_us: float = 300.0,
                    control_interval_ns: float = 8000.0,
                    seed: int = 0) -> ScenarioSpec:
    """Closed-loop QoS (DESIGN.md §6): a latency-SLO victim whose demand
    slightly exceeds its static share, vs a heavy congestor.  The AIMD
    controller boosts the victim's weights until its p99 meets target.
    Serving projection: same shape in engine steps (target scaled)."""
    return ScenarioSpec(
        name="qos_closed_loop",
        description="closed-loop QoS: AIMD weight control holds the "
                    "victim's p99 (DESIGN.md §6)",
        backends=("sim", "serve"),
        tenants=(
            TenantSpec("congestor", workload=_spin("congestor", 2.0),
                       arrival=ArrivalSpec(size=1024, share=0.25,
                                           requests=12, prompt_len=160,
                                           max_new_tokens=48)),
            TenantSpec("victim", workload=_spin("victim", 2.0),
                       arrival=ArrivalSpec(size=256, share=0.175,
                                           seed_offset=1, requests=48,
                                           prompt_len=16, max_new_tokens=8),
                       p99_target=p99_target_ns),
        ),
        controller=(ControllerSpec(interval_ns=control_interval_ns,
                                   interval_steps=16,
                                   target_scale_serve=40.0 / 2000.0)
                    if controller else None),
        duration_us=duration_us, seed=seed,
        serve=ServeSpec(max_slots=8, max_len=512, prefill_chunk=32,
                        kv_overcommit=2.0))


@register_scenario("fleet_sweep")
def fleet_sweep(*, tenants: int = 128, duration_us: float = 10240.0,
                pkt_size: int = 512, fifo_capacity: int = 256,
                congestor_every: int = 4, watchdog_cycles: int = 20000,
                seed: int = 0) -> ScenarioSpec:
    """Tenant-*count* scale sweep on ONE simulated NIC (DESIGN.md §8):
    ``tenants`` flows share a single fully-utilized 400G link against
    32 PUs — a deliberately overloaded consolidation point
    (SuperNIC/Meili-style) where drops, ECN marks and watchdog kills
    all fire at volume.  Despite the name this is NOT the multi-NIC
    fabric family: no switch is modeled and nothing crosses a
    crossbar.  For N NICs exchanging traffic through the modeled
    VOQ/crossbar switch — placement, live migration, global QoS — see
    the ``fleet_fabric`` / ``fleet_incast`` / ``fleet_migrate``
    scenarios (repro_torch.fleet.scenarios, DESIGN.md §12).

    Four service classes cycle across the fleet: light RPC handlers,
    histogram analytics, heavy ML preprocessing, and watchdog-bounded
    batch congestors (every ``congestor_every``-th tenant).  At the
    128-tenant default the trace is ~10^6 packets — built as
    ``TraceArrays`` and meant for the batched datapath (the event loop
    makes identical decisions, ~10x slower).  ``horizon_us`` pins the
    measurement window, fig9-style, instead of draining the backlog.
    """
    classes = (
        ("rpc", _spin("rpc", 3.0)),
        ("analytics", _spin("analytics", 5.0)),
        ("mlprep", _spin("mlprep", 9.0)),
        ("batch", WorkloadSpec(name="batch", compute_base=40.0,
                               compute_per_byte=4.0, spin_factor=4.0)),
    )
    rows = []
    for i in range(tenants):
        if congestor_every and i % congestor_every == congestor_every - 1:
            cname, wl = classes[3]
            limit = watchdog_cycles
        else:
            cname, wl = classes[i % 3]
            limit = 0
        rows.append(TenantSpec(
            f"{cname}{i}", workload=wl,
            kernel_cycle_limit=limit,
            arrival=ArrivalSpec(size=pkt_size, share=1.0 / tenants,
                                seed_offset=i)))
    return ScenarioSpec(
        name="fleet_sweep",
        description=f"{tenants}-tenant fleet flood on 32 PUs: mixed "
                    "service classes, watchdogged congestors, batched "
                    "datapath (DESIGN.md §8)",
        tenants=tuple(rows),
        duration_us=duration_us, horizon_us=duration_us,
        fifo_capacity=fifo_capacity, datapath="batched", seed=seed)


@register_scenario("ppb_service_time")
def ppb_service_time() -> ScenarioSpec:
    """Paper Fig. 3: per-workload single-packet service time vs the
    per-packet budget — analytic (no event loop)."""
    return ScenarioSpec(
        name="ppb_service_time",
        description="service time vs per-packet budget, all workloads "
                    "(paper Fig. 3; analytic)",
        analytic="ppb")


# ---------------------------------------------------------------------------
# serving-native scenarios
# ---------------------------------------------------------------------------
@register_scenario("serve_mixed_slo")
def serve_mixed_slo(*, tenants: int = 3, requests: int = 12,
                    max_slots: int = 8, max_len: int = 256,
                    prefill_chunk: int = 32, scheduler: str = "wlbvt",
                    arbiter: str = "dwrr", vocab: int = 90,
                    seed: int = 0) -> ScenarioSpec:
    """The ``launch/serve.py`` default workload: tenant 0 at 2x priority,
    tenant 1 the long-prompt congestor, the rest interactive victims."""
    quota = max_len * max(2, max_slots // tenants)
    n = [len(range(t, requests, tenants)) for t in range(tenants)]
    return ScenarioSpec(
        name="serve_mixed_slo",
        description="serving driver workload: priority tenant + congestor "
                    "+ interactive victims",
        backends=("serve",),
        tenants=tuple(
            TenantSpec(f"tenant{t}",
                       priority=2.0 if t == 0 else 1.0,
                       kv_quota_tokens=quota,
                       arrival=ArrivalSpec(
                           requests=n[t],
                           prompt_len=max_len // 2 if t == 1 else 8,
                           max_new_tokens=32 if t == 1 else 8))
            for t in range(tenants)),
        scheduler=scheduler, arbiter=arbiter, seed=seed,
        serve=ServeSpec(max_slots=max_slots, max_len=max_len,
                        prefill_chunk=prefill_chunk, vocab=vocab))


@register_scenario("serve_congestor_victim")
def serve_congestor_victim(*, scheduler: str = "wlbvt",
                           arbiter: str = "dwrr", rounds: int = 30,
                           seed: int = 0) -> ScenarioSpec:
    """The adapted fairness benchmark: two 4x-work congestor tenants vs
    two interactive victims on a 16-slot engine."""
    return ScenarioSpec(
        name="serve_congestor_victim",
        description="serving fairness benchmark: 2 congestors vs 2 "
                    "victims, WLBVT+DWRR vs RR+FIFO",
        backends=("serve",),
        tenants=tuple(
            TenantSpec(name, kv_quota_tokens=256 * 8,
                       arrival=ArrivalSpec(
                           requests=rounds,
                           prompt_len=256 if i < 2 else 16,
                           max_new_tokens=64 if i < 2 else 16))
            for i, name in enumerate(("congestor0", "congestor1",
                                      "victim0", "victim1"))),
        scheduler=scheduler, arbiter=arbiter, seed=seed,
        serve=ServeSpec(max_slots=16, max_len=512, prefill_chunk=64,
                        prefill_slots_per_step=4))


@register_scenario("serve_three_class")
def serve_three_class(*, scheduler: str = "wlbvt", arbiter: str = "dwrr",
                      requests: int = 6, vocab: int = 90,
                      seed: int = 0) -> ScenarioSpec:
    """The multi-tenant serving example: batch congestor (watchdogged),
    interactive victim, and a 2x-priority premium tenant."""
    return ScenarioSpec(
        name="serve_three_class",
        description="three service classes on one engine: batch / "
                    "interactive / premium(2x)",
        backends=("serve",),
        tenants=(
            TenantSpec("batch", kv_quota_tokens=256 * 2,
                       kernel_cycle_limit=240,
                       arrival=ArrivalSpec(requests=requests, prompt_len=160,
                                           max_new_tokens=48)),
            TenantSpec("interactive", kv_quota_tokens=256 * 2,
                       arrival=ArrivalSpec(requests=requests, prompt_len=12,
                                           max_new_tokens=12)),
            TenantSpec("premium", priority=2.0, kv_quota_tokens=256 * 2,
                       arrival=ArrivalSpec(requests=requests, prompt_len=12,
                                           max_new_tokens=12)),
        ),
        scheduler=scheduler, arbiter=arbiter, seed=seed,
        serve=ServeSpec(max_slots=6, max_len=256, prefill_chunk=32,
                        vocab=vocab))


# ---------------------------------------------------------------------------
# fleet-plane scenarios (multi-NIC fabric): registered on import; the
# registry loads only this module, so the fleet catalog hooks in here
# ---------------------------------------------------------------------------
from repro_torch.fleet import scenarios as _fleet_scenarios  # noqa: E402,F401
