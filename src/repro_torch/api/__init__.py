"""Runtime API, serving side: declarative scenarios, the serving runtime
adapter and portable run reports."""
from repro_torch.api.registry import (get_scenario, list_scenarios,
                                      register_scenario)
from repro_torch.api.report import (SCHEMA_VERSION, TENANT_FIELDS, RunReport,
                                    TenantReport)
from repro_torch.api.runtime import ServeRuntime, build_requests
from repro_torch.api.spec import (ArrivalSpec, ControllerSpec,
                                  ScenarioSpec, ServeSpec, TenantSpec,
                                  WorkloadSpec)

__all__ = [
    "get_scenario", "list_scenarios", "register_scenario",
    "SCHEMA_VERSION", "TENANT_FIELDS", "RunReport", "TenantReport",
    "ServeRuntime", "build_requests",
    "ArrivalSpec", "ControllerSpec", "ScenarioSpec",
    "ServeSpec", "TenantSpec", "WorkloadSpec",
]
