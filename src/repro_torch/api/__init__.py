"""Runtime API: declarative scenarios and sweep plans, the serving
runtime adapter, packet-trace synthesis and portable run reports."""
from repro_torch.api.registry import (get_scenario, list_scenarios,
                                      register_scenario)
from repro_torch.api.report import (SCHEMA_VERSION, TENANT_FIELDS, RunReport,
                                    TenantReport)
from repro_torch.api.runtime import (ServeRuntime, build_requests,
                                     build_traces)
from repro_torch.api.spec import (ArrivalSpec, ControllerSpec,
                                  ScenarioSpec, ServeSpec, TenantSpec,
                                  WorkloadSpec)
from repro_torch.api.sweep import SweepAxis, SweepSpec, apply_knob

__all__ = [
    "get_scenario", "list_scenarios", "register_scenario",
    "SCHEMA_VERSION", "TENANT_FIELDS", "RunReport", "TenantReport",
    "ServeRuntime", "build_requests", "build_traces",
    "ArrivalSpec", "ControllerSpec", "ScenarioSpec",
    "ServeSpec", "TenantSpec", "WorkloadSpec",
    "SweepSpec", "SweepAxis", "apply_knob",
]
