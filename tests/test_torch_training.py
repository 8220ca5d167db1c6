"""The port's training path against the JAX package's, on the CPU.

Inputs come from numpy seeds (or the reference's own initial state,
carried across with ``weights.train_state_from_reference``); both packages
run in float32.  The optimizers, the schedule and the loss are held at
1e-6 relative: the same arithmetic in the same order, with sums taken in
another order.  Whole training steps are held at 1e-5 relative on the
losses and 2e-5 absolute on the parameters (sums over a batch and over
the vocabulary in another order, through two layers).  The data pipeline
is the reference's bit for bit.  The port's attention runs ``chunked``
and ``pallas`` (on CPU tensors, the flash kernels' plain versions); the
reference runs ``chunked``, since its Pallas forward has no gradient.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import smoke_config as jax_smoke_config
from repro.training import checkpoint as JCKPT
from repro.training import optimizer as JOPT
from repro.training import data as jdata
from repro.training.trainer import build_trainer as jax_build_trainer
from repro.training.trainer import cross_entropy as jax_cross_entropy
from repro_torch.configs import smoke_config
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as train_cli
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as OPT
from repro_torch.training.trainer import (build_trainer, cross_entropy,
                                          make_loss_fn)
from repro_torch.weights import train_state_from_reference

SEQ, BATCH, STEPS = 32, 4, 3
OPT_RTOL = 1e-6


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# optimizers, schedule, clipping
# ---------------------------------------------------------------------------
SHAPES = {"w": (8, 16), "b": (16,), "s": (3, 4, 5)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(jopt, topt, steps=3):
    """``steps`` updates with the same gradients through both; yields the
    (reference, port) params after each step."""
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jst, tst = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = _tree(10 + i, scale=3.0)
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp)
        jp = JOPT.apply_updates(jp, ju)
        tu, tst = topt.update({k: torch.from_numpy(v.copy())
                               for k, v in g.items()}, tst, tp)
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), _np(ju[k]),
                                       rtol=OPT_RTOL, atol=1e-9)
        OPT.apply_updates(tp, tu)
        yield jp, tp, jst, tst


def test_adamw_matches_jax_on_same_inputs():
    lr = dict(base_lr=1e-2, total_steps=20, warmup_steps=2)
    kw = dict(weight_decay=0.1, max_grad_norm=1.0)     # clipping is active
    for jp, tp, jst, tst in _run_both(
            JOPT.adamw(JOPT.cosine_schedule(**lr), **kw),
            OPT.adamw(OPT.cosine_schedule(**lr), **kw)):
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]),
                                       rtol=OPT_RTOL, atol=1e-9)
            for slot in ("m", "v"):
                np.testing.assert_allclose(tst[slot][k].numpy(),
                                           _np(jst[slot][k]),
                                           rtol=OPT_RTOL, atol=1e-12)
        assert int(tst["step"]) == int(jst["step"])


def test_adafactor_matches_jax_on_same_inputs():
    lr = dict(base_lr=1e-2, total_steps=20, warmup_steps=2)
    for jp, tp, jst, tst in _run_both(
            JOPT.adafactor(JOPT.cosine_schedule(**lr), weight_decay=0.01),
            OPT.adafactor(OPT.cosine_schedule(**lr), weight_decay=0.01)):
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]),
                                       rtol=OPT_RTOL, atol=1e-9)
            for name, t in tst["slots"][k].items():
                np.testing.assert_allclose(t.numpy(),
                                           _np(jst["slots"][k][name]),
                                           rtol=OPT_RTOL)
    assert tst["slots"]["w"]["v_row"].shape == (8,)
    assert tst["slots"]["s"]["v_col"].shape == (3, 5)
    assert tst["slots"]["b"]["v"].shape == (16,)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(5, scale=4.0)
    jc, jn = JOPT.clip_by_global_norm({k: jnp.asarray(v)
                                       for k, v in g.items()}, max_norm)
    tc, tn = OPT.clip_by_global_norm({k: torch.from_numpy(v)
                                      for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(tn.numpy(), _np(jn), rtol=OPT_RTOL)
    for k in SHAPES:
        np.testing.assert_allclose(tc[k].numpy(), _np(jc[k]), rtol=OPT_RTOL)
    np.testing.assert_allclose(OPT.global_norm(tc.values()).numpy(),
                               _np(JOPT.global_norm(jc)), rtol=OPT_RTOL)


def test_cosine_schedule_matches_jax():
    kw = dict(base_lr=3e-4, total_steps=1000, warmup_steps=100)
    jlr, tlr = JOPT.cosine_schedule(**kw), OPT.cosine_schedule(**kw)
    for step in (0, 1, 50, 99, 100, 101, 400, 999, 1000, 1500):
        np.testing.assert_allclose(
            tlr(torch.tensor(step, dtype=torch.int32)).numpy(),
            _np(jlr(jnp.int32(step))), rtol=OPT_RTOL)


def test_make_optimizer_follows_the_config():
    cfg = smoke_config("qwen3-8b")
    assert set(OPT.make_optimizer(cfg).init(
        {"w": torch.zeros(2, 3)})) == {"m", "v", "step"}
    cfg = dataclasses.replace(cfg, optimizer="adafactor")
    assert set(OPT.make_optimizer(cfg).init(
        {"w": torch.zeros(2, 3)})) == {"slots", "step"}
    with pytest.raises(ValueError, match="optimizer"):
        OPT.make_optimizer(dataclasses.replace(cfg, optimizer="sgd"))


# ---------------------------------------------------------------------------
# data, loss
# ---------------------------------------------------------------------------
def test_synthetic_lm_batches_are_the_references_bit_for_bit():
    jcfg, tcfg = jax_smoke_config("qwen3-8b"), smoke_config("qwen3-8b")
    j = jdata.SyntheticLM(jcfg, SEQ, BATCH, seed=7, host_index=1,
                          num_hosts=2)
    t = tdata.SyntheticLM(tcfg, SEQ, BATCH, seed=7, host_index=1,
                          num_hosts=2)
    for _ in range(3):
        a, b = next(j), next(t)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert t.state() == j.state()
    t.restore({"kind": "synthetic", "step": 1, "seed": 7})
    j.restore({"kind": "synthetic", "step": 1, "seed": 7})
    assert np.array_equal(next(t)["tokens"], next(j)["tokens"])


def test_memmap_corpus_and_prefetcher_match_the_reference(tmp_path):
    path = tmp_path / "corpus.bin"
    np.arange(5000, dtype=np.int32).tofile(path)
    jcfg, tcfg = jax_smoke_config("qwen3-8b"), smoke_config("qwen3-8b")
    j = jdata.make_pipeline(jcfg, 16, 4, corpus_path=str(path), seed=3)
    t = tdata.make_pipeline(tcfg, 16, 4, corpus_path=str(path), seed=3,
                            prefetch=True)
    for _ in range(3):
        assert np.array_equal(next(j)["tokens"], next(t)["tokens"])
    assert t.state()["step"] == 3
    t.close()


def test_cross_entropy_masking_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    js, jn = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    ts, tn = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(tn) == int(jn) == 8
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=OPT_RTOL)
    # a masked position contributes nothing, whatever its logits
    logits[0, 1] += 100.0
    ts2, _ = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(ts2.numpy(), ts.numpy(), rtol=OPT_RTOL)


# ---------------------------------------------------------------------------
# whole training steps against the JAX trainer
# ---------------------------------------------------------------------------
def _cfgs(port_impl):
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-8b"), dtype="float32",
                               attn_impl="chunked")
    tcfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32",
                               attn_impl=port_impl)
    return jcfg, tcfg


TRAIN_KW = dict(total_steps=10, warmup_steps=2)


def _batches(cfg, n, seed=0):
    src = jdata.SyntheticLM(cfg, SEQ, BATCH, seed=seed)
    return [next(src) for _ in range(n)]


@pytest.fixture(scope="module")
def reference_run():
    """The JAX trainer's initial state and 3 steps (losses, params)."""
    jcfg, _ = _cfgs("chunked")
    tr = jax_build_trainer(jcfg, donate=False, **TRAIN_KW)
    state = tr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    losses, norms = [], []
    for b in _batches(jcfg, STEPS + 1):
        state, m = tr.train_step(state, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, losses, norms, jax.tree.map(np.asarray, state), tr


def _port_state(init, tcfg):
    return train_state_from_reference(init.params, init.opt_state,
                                      init.step, tcfg)


def _assert_params_match(state, np_params, tcfg, atol=2e-5):
    from repro_torch.weights import named_arrays
    want = named_arrays(np_params, tcfg)
    got = state.named_params()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, atol=atol,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("port_impl", ["chunked", "pallas"])
def test_train_steps_match_the_jax_trainer(reference_run, port_impl):
    init, jlosses, jnorms, _, _ = reference_run
    _, tcfg = _cfgs(port_impl)
    tr = build_trainer(tcfg, device="cpu", **TRAIN_KW)
    state = _port_state(init, tcfg)
    p0 = {k: v.detach().clone() for k, v in state.named_params().items()}
    losses, norms = [], []
    for b in _batches(tcfg, STEPS):
        state, m = tr.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        assert m["loss"].device.type == "cpu" and m["loss"].dim() == 0
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, jlosses[:STEPS], rtol=1e-5)
    np.testing.assert_allclose(norms, jnorms[:STEPS], rtol=1e-4)
    assert int(state.step) == STEPS
    # the parameters moved, and by the reference's amounts: run the
    # reference for the same 3 steps from its initial state
    jcfg, _ = _cfgs("chunked")
    jtr = jax_build_trainer(jcfg, donate=False, **TRAIN_KW)
    js = jax.tree.map(jnp.asarray, init)
    for b in _batches(jcfg, STEPS):
        js, _ = jtr.train_step(js, {k: jnp.asarray(v) for k, v in b.items()})
    _assert_params_match(state, jax.tree.map(np.asarray, js.params), tcfg)
    moved = max((p - p0[k]).abs().max().item()
                for k, p in state.named_params().items())
    assert moved > 1e-4


def test_grad_accum_equals_one_full_batch():
    _, tcfg = _cfgs("pallas")
    b = {k: torch.from_numpy(v) for k, v in _batches(tcfg, 1)[0].items()}
    out = []
    for accum in (1, 4):
        tr = build_trainer(tcfg, device="cpu", grad_accum=accum, **TRAIN_KW)
        state = tr.init_state(0)
        state, m = tr.train_step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: v.detach().clone()
                     for k, v in state.named_params().items()}))
    (l1, g1, p1), (l4, g4, p4) = out
    assert l1 == pytest.approx(l4, rel=1e-5)
    assert g1 == pytest.approx(g4, rel=1e-4)
    for k in p1:
        torch.testing.assert_close(p4[k], p1[k], atol=1e-6, rtol=0)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients_and_reruns_attention(remat,
                                                            monkeypatch):
    _, tcfg = _cfgs("pallas")
    b = {k: torch.from_numpy(v) for k, v in _batches(tcfg, 1)[0].items()}
    calls = {"n": 0}
    real = tref.flash_attention_ref

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(tref, "flash_attention_ref", counted)
    grads = []
    for r in ("none", remat):
        cfg = dataclasses.replace(tcfg, remat=r)
        tr = build_trainer(cfg, device="cpu", **TRAIN_KW)
        state = tr.init_state(0)
        calls["n"] = 0
        loss, _ = make_loss_fn(tr.model, cfg)(state.params, b)
        loss.backward()
        grads.append({k: p.grad.clone()
                      for k, p in state.params.named_parameters()})
        if r == "none":
            assert calls["n"] == cfg.num_layers
        elif r == "full":           # the backward recomputes every layer
            assert calls["n"] == 2 * cfg.num_layers
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-6,
                                   rtol=1e-5)


def test_trainer_refuses_a_mesh_and_a_missing_card():
    _, tcfg = _cfgs("pallas")
    with pytest.raises(NotImplementedError, match="mesh"):
        build_trainer(tcfg, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_trainer(tcfg)


# ---------------------------------------------------------------------------
# the CLI and checkpoints
# ---------------------------------------------------------------------------
def test_launch_train_runs_end_to_end_on_cpu(capsys):
    rc = train_cli.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                         "--steps", "3", "--seq-len", "16",
                         "--global-batch", "4", "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(lines) == 3 and all("loss" in ln for ln in lines)


def test_launch_train_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"])


def _final_params(state):
    return {k: v.detach().clone() for k, v in state.named_params().items()}


def test_save_load_resume_equals_an_uninterrupted_run(tmp_path):
    _, tcfg = _cfgs("pallas")
    kw = dict(seq_len=16, global_batch=4, seed=0, log_every=1,
              device="cpu", log=lambda s: None)
    full, hist = train_cli.run_training(tcfg, steps=4, **kw)
    d = str(tmp_path / "ckpt")
    # with 100 warmup steps the schedule does not depend on the total
    train_cli.run_training(tcfg, steps=2, ckpt_dir=d, ckpt_every=1, **kw)
    assert CKPT.latest_step(d) == 2
    logs = []
    resumed, rhist = train_cli.run_training(
        tcfg, steps=4, ckpt_dir=d, resume=True,
        **dict(kw, log=logs.append))
    assert "resumed from step 2" in logs
    assert [h["loss"] for h in rhist] == [h["loss"] for h in hist[2:]]
    a, b = _final_params(full), _final_params(resumed)
    for k in a:
        torch.testing.assert_close(b[k], a[k], atol=0, rtol=0)
    for k, t in CKPT.state_leaves(full).items():
        if k.startswith("opt_state"):
            torch.testing.assert_close(CKPT.state_leaves(resumed)[k], t,
                                       atol=0, rtol=0)


def test_checkpoint_layout_gc_and_async_snapshot(tmp_path):
    _, tcfg = _cfgs("pallas")
    tr = build_trainer(tcfg, device="cpu", **TRAIN_KW)
    state = tr.init_state(1)
    d = str(tmp_path / "ck")
    for s in (1, 2, 3):
        CKPT.save(state, d, s, extra={"step": s}, keep=2)
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == ["LATEST", "step_00000002", "step_00000003"]
    assert (tmp_path / "ck" / "step_00000003" / "index.json").exists()
    ac = CKPT.AsyncCheckpointer(d)
    want = _final_params(state)
    ac.save(state, 4, extra={"step": 4})
    with torch.no_grad():                  # training goes on changing it
        for p in state.params.parameters():
            p.add_(1.0)
    ac.wait()
    fresh = tr.init_state(2)
    fresh, extra = CKPT.load(d, fresh)
    assert extra == {"step": 4}
    for k, v in _final_params(fresh).items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0)
    with pytest.raises(FileNotFoundError):
        CKPT.load(str(tmp_path / "none"), fresh)


def test_a_jax_checkpoint_loads_into_the_port_and_steps_alike(tmp_path,
                                                              reference_run):
    init, jlosses, _, final, jtr = reference_run
    jcfg, tcfg = _cfgs("pallas")
    # the reference's own unsharded save, after one step
    js = jax.tree.map(jnp.asarray, init)
    batches = _batches(jcfg, 2)
    js, _ = jtr.train_step(js, {k: jnp.asarray(v)
                                for k, v in batches[0].items()})
    d = str(tmp_path / "jax_ckpt")
    JCKPT.save(js, d, 1, extra={"step": 1})
    tr = build_trainer(tcfg, device="cpu", **TRAIN_KW)
    state, extra = CKPT.load(d, tr.init_state(5))
    assert extra == {"step": 1} and int(state.step) == 1
    host = jax.tree.map(np.asarray, js)
    _assert_params_match(state, host.params, tcfg, atol=0)
    assert int(state.opt_state["step"]) == 1
    # one further step from it equals the reference's second step
    state, m = tr.train_step(state, {k: torch.from_numpy(v)
                                     for k, v in batches[1].items()})
    assert float(m["loss"]) == pytest.approx(jlosses[1], rel=1e-5)
    js, _ = jtr.train_step(js, {k: jnp.asarray(v)
                                for k, v in batches[1].items()})
    _assert_params_match(state, jax.tree.map(np.asarray, js.params), tcfg)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_adafactor_state_of_the_reference(scan_layers):
    """Unstacked layers: the slots carry over and 3 Adafactor steps equal
    the reference's.  Stacked groups: the reference factors the stacked
    norm scales, which have no per-layer counterpart, and this raises."""
    jcfg, tcfg = (dataclasses.replace(c, optimizer="adafactor",
                                      scan_layers=scan_layers)
                  for c in _cfgs("pallas"))
    jcfg = dataclasses.replace(jcfg, attn_impl="chunked")
    jtr = jax_build_trainer(jcfg, donate=False, **TRAIN_KW)
    js = jtr.init_state(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, js)
    if scan_layers:
        with pytest.raises(NotImplementedError, match="Adafactor"):
            train_state_from_reference(host.params, host.opt_state,
                                       host.step, tcfg)
        return
    state = train_state_from_reference(host.params, host.opt_state,
                                       host.step, tcfg)
    tr = build_trainer(tcfg, device="cpu", **TRAIN_KW)
    for b in _batches(jcfg, STEPS):
        js, jm = jtr.train_step(js, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = tr.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    host = jax.tree.map(np.asarray, js)
    _assert_params_match(state, host.params, tcfg)
    # the reference's slots after 3 steps, carried over, are the port's
    want = train_state_from_reference(host.params, host.opt_state,
                                      host.step, tcfg).opt_state["slots"]
    got = state.opt_state["slots"]
    assert set(got) == set(want)
    for name, slot in want.items():
        for part, t in slot.items():
            torch.testing.assert_close(got[name][part], t, rtol=1e-4,
                                       atol=1e-12)
