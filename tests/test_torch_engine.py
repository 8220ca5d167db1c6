"""The port's serving engine against the JAX package's.

With the model executor: ``serve_mixed_slo`` (3 tenants, 6 requests,
max_len 64, prefill chunk 16) on the float32 smoke models of Qwen3,
Mamba2 and RecurrentGemma, the port loading the reference's weights and
running ``pallas`` (the kernels' plain versions on the CPU), the
reference ``chunked``; per-tenant results, EQ events, every request's
generated tokens and, for the recurrent models (9 requests on 6 slots,
so slots are reassigned), the whole RunReport must be equal.  With the
scheduling-only ``NullExecutor``: every serving scenario's
``RunReport.to_json()`` must be identical.
"""
import pytest

# the card's machine has no JAX: there these modules, which hold no
# ``gpu`` test, skip as a whole
jax = pytest.importorskip("jax")

import _torch_parity as P
from repro.api import ServeRuntime as JaxServeRuntime
from repro.api import get_scenario as jax_get_scenario
from repro_torch.api import ServeRuntime, get_scenario


@pytest.fixture(scope="module")
def model_runs():
    return P.run_model_engines("qwen3-8b")


def test_model_engine_tenant_results_match(model_runs):
    _, jrep, _, trep = model_runs
    assert sorted(trep.tenants) == sorted(jrep.tenants)
    for t, want in jrep.tenants.items():
        got = trep.tenants[t]
        assert (got.completed, got.killed) == (want.completed, want.killed)
        assert got.extra["mean_fct"] == want.extra["mean_fct"]
    assert sum(r.completed for r in trep.tenants.values()) == 6
    assert trep.extras == jrep.extras


def test_model_engine_events_match(model_runs):
    _, jrep, _, trep = model_runs
    assert trep.events == jrep.events


def test_model_engine_generated_tokens_match(model_runs):
    jrt, _, trt, _ = model_runs
    jdone = sorted(jrt.engine.done, key=lambda r: r.rid)
    tdone = sorted(trt.engine.done, key=lambda r: r.rid)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for j, t in zip(jdone, tdone):
        assert t.status.value == j.status.value
        assert t.generated == j.generated, f"rid {j.rid}"


class _Built(Exception):
    """Raised by the stand-in ``build_serve_fns`` once it has the call."""


def test_model_executor_passes_the_reference_keywords(monkeypatch):
    """Both executors hand ``build_serve_fns`` the same keywords, the
    engine config's ``prefill_chunk`` among them (the port adds only
    ``device``); the stand-in stops before a model is built."""
    import repro.serving.serve_step as jax_serve_step
    import repro_torch.serving.engine as torch_engine
    from repro.configs import smoke_config as jax_smoke_config
    from repro.serving.engine import EngineConfig as JaxEngineConfig
    from repro.serving.engine import ModelExecutor as JaxModelExecutor
    from repro_torch.configs import smoke_config
    from repro_torch.serving.engine import EngineConfig, ModelExecutor
    calls = {}

    def stand_in(side):
        def build(cfg, mesh=None, **kw):
            calls[side] = kw
            raise _Built
        return build

    monkeypatch.setattr(jax_serve_step, "build_serve_fns", stand_in("jax"))
    monkeypatch.setattr(torch_engine, "build_serve_fns", stand_in("torch"))
    ecfg = dict(max_slots=2, max_len=32, prefill_chunk=8)
    with pytest.raises(_Built):
        JaxModelExecutor(jax_smoke_config("qwen3-8b"), JaxEngineConfig(**ecfg))
    with pytest.raises(_Built):
        ModelExecutor(smoke_config("qwen3-8b"), EngineConfig(**ecfg),
                      device="cpu")
    assert calls["torch"].pop("device") == "cpu"
    assert calls["torch"] == calls["jax"]
    assert calls["torch"]["prefill_chunk"] == 8


@pytest.fixture(scope="module", params=["mamba2-370m", "recurrentgemma-2b"])
def recurrent_runs(request):
    # 6 slots for 9 requests: slots are reassigned, so a slot's recurrent
    # state must be reset between requests for the tokens to agree
    return P.run_model_engines(request.param, max_slots=6, requests=9)


def test_recurrent_model_engine_reports_match(recurrent_runs):
    _, jrep, _, trep = recurrent_runs
    assert sum(r.completed for r in trep.tenants.values()) == 9
    assert trep.to_json() == jrep.to_json()


def test_recurrent_model_engine_events_match(recurrent_runs):
    _, jrep, _, trep = recurrent_runs
    assert trep.events == jrep.events


def test_recurrent_model_engine_generated_tokens_match(recurrent_runs):
    jrt, _, trt, _ = recurrent_runs
    jdone = sorted(jrt.engine.done, key=lambda r: r.rid)
    tdone = sorted(trt.engine.done, key=lambda r: r.rid)
    assert [(r.rid, r.status.value, r.generated) for r in tdone] == \
        [(r.rid, r.status.value, r.generated) for r in jdone]


@pytest.mark.parametrize("name", ["serve_mixed_slo", "serve_congestor_victim",
                                  "serve_three_class"])
def test_null_executor_reports_identical(name):
    jspec, tspec = jax_get_scenario(name), get_scenario(name)
    assert tspec.to_dict() == jspec.to_dict()
    jrep = JaxServeRuntime.from_spec(jspec).run(jspec).validate()
    trep = ServeRuntime.from_spec(tspec).run(tspec).validate()
    assert trep.to_json() == jrep.to_json()
