"""Built-in serving scenario catalog: the serving-native scenarios as
registered declarative ``ScenarioSpec`` factories.

The simulator scenarios (paper Figs. 9-13, the fleet catalog) register
with the simulator's port.
"""
from __future__ import annotations

from repro_torch.api.registry import register_scenario
from repro_torch.api.spec import (ArrivalSpec, ScenarioSpec, ServeSpec,
                                  TenantSpec)


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
