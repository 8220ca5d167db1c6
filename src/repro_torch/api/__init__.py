"""Unified OSMOSIS runtime API (DESIGN.md §7): one control-plane surface
over both execution substrates.

``Runtime``       — the protocol (tenant lifecycle, workload injection,
                    clock, controller attach, reports);
``SimRuntime``    — adapter over the cycle-level PsPIN simulator;
``ServeRuntime``  — adapter over the multi-tenant serving engine;
``ScenarioSpec``  — declarative scenarios (+ named registry) and sweep
                    plans;
``RunReport``     — the portable, JSON round-trippable result schema
                    both backends emit.
"""
from repro_torch.api.registry import (get_scenario, list_scenarios,
                                      register_scenario)
from repro_torch.api.report import (SCHEMA_VERSION, TENANT_FIELDS, RunReport,
                                    TenantReport)
from repro_torch.api.runtime import (Runtime, ServeRuntime, SimRuntime,
                                     build_requests, build_traces,
                                     make_runtime, run_scenario)
from repro_torch.api.spec import (ArrivalSpec, ControllerSpec,
                                  ScenarioSpec, ServeSpec, TenantSpec,
                                  WorkloadSpec)
from repro_torch.api.sweep import SweepAxis, SweepSpec, apply_knob

__all__ = [
    "Runtime", "SimRuntime", "ServeRuntime", "make_runtime", "run_scenario",
    "build_traces", "build_requests",
    "ScenarioSpec", "TenantSpec", "ArrivalSpec", "WorkloadSpec",
    "ControllerSpec", "ServeSpec",
    "SweepSpec", "SweepAxis", "apply_knob",
    "RunReport", "TenantReport", "SCHEMA_VERSION", "TENANT_FIELDS",
    "register_scenario", "get_scenario", "list_scenarios",
]
