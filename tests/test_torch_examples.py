"""The port's examples (``repro_torch.examples``) against the JAX
package's scripts in ``examples/``, loaded by path and run unchanged
(their module globals are only wrapped, to record what they build).

The host examples print the reference's stdout.  The model examples run
here with ``--device cpu`` (the kernels' plain versions) on the
reference's own weights, carried across with ``weights.params_from_jax``
and ``weights.train_state_from_reference``, both packages in float32:
``multi_tenant_serving``'s RunReport and served token ids equal the
reference's, ``quickstart``'s three losses hold to the trainer parity of
``tests/test_torch_training.py`` (1e-5) and its served tokens and
completion times are equal.  ``train_100m`` keeps the reference's
widths, trains 2 short steps here, writes a checkpoint that loads back
bit for bit, and refuses a mesh.  Without ``--device cpu`` a model
example raises on a machine with no card.
"""
import contextlib
import dataclasses
import importlib.util
import io
import math
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import (fairness_demo, multi_tenant_serving,
                                  qos_controller_demo, quickstart,
                                  train_100m)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")


def _reference(name, monkeypatch, argv=()):
    """The JAX package's ``examples/<name>.py`` as a module (not run);
    ``sys.argv`` set for its ``main()``."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return mod


def _stdout(fn, *a, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a, **kw)
    return buf.getvalue()


def _f32(smoke_config):
    return lambda name: dataclasses.replace(smoke_config(name),
                                            dtype="float32")


# ---------------------------------------------------------------------------
# host examples: stdout equal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("exp", ["fig9", "fig13"])
def test_fairness_demo_prints_the_reference(exp, monkeypatch):
    ref = _reference("fairness_demo", monkeypatch, ["--exp", exp])
    want = _stdout(ref.main)
    assert want and _stdout(fairness_demo.main, ["--exp", exp]) == want


def test_qos_controller_demo_prints_the_reference(monkeypatch):
    ref = _reference("qos_controller_demo", monkeypatch)
    want = _stdout(ref.main)
    assert "controller=on" in want
    assert _stdout(qos_controller_demo.main, []) == want


# ---------------------------------------------------------------------------
# model examples on the reference's weights
# ---------------------------------------------------------------------------
def _capture_executor(ref, kept):
    """Wrap the reference script's ``ModelExecutor`` so its random
    parameters are kept (as numpy)."""
    import jax

    class Executor(ref.ModelExecutor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(jax.tree.map(np.asarray, self.params))
    return Executor


def _capture_runtime(runtime, reports, served):
    """Wrap a ``ServeRuntime`` so each run's report is kept, and the
    token ids its engine generated for each finished request."""
    class Runtime(runtime):
        def run(self, spec):
            reports.append(super().run(spec))
            served.append({r.rid: list(map(int, r.generated))
                           for r in self.engine.done})
            return reports[-1]
    return Runtime


def test_multi_tenant_serving_report_equals_the_reference(monkeypatch):
    from repro_torch.configs import smoke_config
    from repro_torch.weights import params_from_jax
    ref = _reference("multi_tenant_serving", monkeypatch)
    params, reports, served = [], [], []
    monkeypatch.setattr(ref, "smoke_config", _f32(ref.smoke_config))
    monkeypatch.setattr(ref, "ModelExecutor",
                        _capture_executor(ref, params))
    monkeypatch.setattr(ref, "ServeRuntime",
                        _capture_runtime(ref.ServeRuntime, reports, served))
    want_out = _stdout(ref.main)
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32",
                              attn_impl="pallas")
    got_served = []
    monkeypatch.setattr(multi_tenant_serving, "ServeRuntime",
                        _capture_runtime(multi_tenant_serving.ServeRuntime,
                                         [], got_served))
    rep = multi_tenant_serving.run(
        cfg=cfg, params=params_from_jax(params[0], cfg), device="cpu")
    assert rep.to_json() == reports[0].to_json()
    assert all(t.completed == 6 for t in rep.tenants.values())
    # what the model computed on the carried weights: every finished
    # request's generated token ids
    assert len(served[0]) == 18 and all(served[0].values())
    assert got_served == served
    # the engine has no EOS stop, so the printed schedule does not depend
    # on the weights: the port's own (bf16, seed 0) prints the same
    assert (_stdout(multi_tenant_serving.main, ["--device", "cpu"])
            == want_out)


def test_quickstart_trains_and_serves_as_the_reference(monkeypatch):
    import jax
    from repro_torch.configs import smoke_config
    from repro_torch.weights import (params_from_jax,
                                     train_state_from_reference)
    ref = _reference("quickstart", monkeypatch)
    monkeypatch.setattr(ref, "smoke_config", _f32(ref.smoke_config))
    serve_params, inits, losses = [], [], []
    monkeypatch.setattr(ref, "ModelExecutor",
                        _capture_executor(ref, serve_params))
    real_build = ref.build_trainer

    def build_trainer(cfg, **kw):
        tr = real_build(cfg, donate=False, **kw)
        init_state, step = tr.init_state, tr.train_step

        def init(key):
            state = init_state(key)
            inits.append(jax.tree.map(lambda a: np.array(a, copy=True),
                                      state))
            return state

        def train_step(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        return dataclasses.replace(tr, init_state=init,
                                   train_step=train_step)
    monkeypatch.setattr(ref, "build_trainer", build_trainer)
    want = _stdout(ref.main).splitlines()

    cfg = dataclasses.replace(quickstart.model_config(), dtype="float32")
    assert cfg == dataclasses.replace(smoke_config("qwen3-8b"),
                                      dtype="float32", attn_impl="pallas")
    s0 = inits[0]
    state = train_state_from_reference(s0.params, s0.opt_state, s0.step, cfg)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, hist = quickstart.train(cfg, "cpu", state=state)
        eng = quickstart.serve(cfg, "cpu",
                               params=params_from_jax(serve_params[0], cfg))
    np.testing.assert_allclose([float(m["loss"]) for m in hist], losses,
                               rtol=1e-5)
    got = buf.getvalue().splitlines()
    # the served tenants' generated tokens and completion times, and the
    # engine's fairness line, as the reference prints them
    assert got[3:] == want[4:]
    assert len(eng.done) == 2 and all(len(r.generated) == 8
                                      for r in eng.done)
    # the whole script: the parameter count line and 3 steps, 2 tenants
    out = _stdout(quickstart.main, ["--device", "cpu"]).splitlines()
    assert out[0] == want[0]
    assert len(out) == len(want) and all(
        math.isfinite(float(line.split()[-1])) for line in out[1:4])


def test_train_100m_keeps_the_reference_widths_and_trains(tmp_path,
                                                          monkeypatch):
    import jax
    from repro.models.registry import build_model as jax_build_model
    ref = _reference("train_100m", monkeypatch)
    want = ref.config_100m()
    cfg = train_100m.config_100m()
    import _torch_parity as P
    assert P.as_reference(cfg) == dataclasses.asdict(
        dataclasses.replace(want, attn_impl="pallas"))
    shapes = jax.eval_shape(jax_build_model(want).init,
                            jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    ckpt = str(tmp_path / "ckpt")
    monkeypatch.setattr(train_100m, "CKPT_EVERY", 2)
    args = train_100m.parse_args(["--steps", "2", "--seq-len", "32",
                                  "--global-batch", "2", "--device", "cpu",
                                  "--ckpt-dir", ckpt])
    assert (args.grad_accum, args.mesh) == (2, "none")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train_100m.train(args)
    assert buf.getvalue().splitlines()[0] == (
        f"params: {n_ref/1e6:.1f}M   mesh: none")
    assert sum(p.numel() for p in res["state"].params.parameters()) == n_ref
    assert len(res["losses"]) == 2
    assert all(math.isfinite(x) for x in res["losses"])
    assert abs(res["losses"][0] - math.log(32_000)) < 1.0
    # the checkpoint of the last step loads into a fresh state bit for bit
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.trainer import build_trainer
    fresh = build_trainer(cfg, device="cpu").init_state(1)
    loaded, extra = CKPT.load(ckpt, fresh)
    assert extra["step"] == 2
    live = CKPT.state_leaves(res["state"])
    for lid, t in CKPT.state_leaves(loaded).items():
        assert torch.equal(t, live[lid]), lid


def test_train_100m_refuses_a_mesh():
    """A mesh the run's ranks cannot fill is refused (this process is a
    group of one; ``tests/test_torch_sharded_training.py`` trains on
    meshes whose ranks torchrun starts)."""
    with pytest.raises(ValueError, match="needs 8 ranks"):
        train_100m.main(["--mesh", "2x4", "--device", "cpu"])


@pytest.mark.parametrize("example", [quickstart, multi_tenant_serving,
                                     train_100m])
def test_model_examples_default_to_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
