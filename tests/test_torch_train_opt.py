"""The port's training substrate against the JAX package, on the CPU:
AdamW, the schedule, clipping and the decay mask
(``repro_torch.train.optimizer``), the chunked cross-entropy
(``repro_torch.parallel.loss``), the synthetic data and the prefetcher
(``train.data``), checkpoints in the reference's format
(``train.checkpoint``) and the straggler monitor and elastic mesh rule
(``train.fault``).  The same numpy inputs from a seed go through both
packages; tolerances are the reference tests' (``tests/test_substrate.py``).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel.loss import chunked_cross_entropy as ref_ce
from repro.train import checkpoint as ref_ckpt
from repro.train import data as ref_data
from repro.train import fault as ref_fault
from repro.train import optimizer as ref_opt
from repro_torch.parallel.loss import chunked_cross_entropy
from repro_torch.train import checkpoint, data, fault, optimizer

OPT_TOL = 1e-5      # tests/test_substrate.py:39 (atol)
CE_TOL = 1e-5       # tests/test_substrate.py:206 (rtol)

SHAPES = {"w": (6, 5), "scale": (5,), "e": (3, 4, 2)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if getattr(x, "dtype", None) == jnp.bfloat16 else x)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

CFGS = {
    "default": ref_opt.OptConfig(warmup_steps=2, decay_steps=8),
    "no_clip_no_decay": ref_opt.OptConfig(lr=1e-2, warmup_steps=0,
                                          decay_steps=10 ** 9,
                                          weight_decay=0.0, clip_norm=0.0),
    "clipping": ref_opt.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=5,
                                  clip_norm=0.5, weight_decay=0.3),
    "bf16_moments": ref_opt.OptConfig(warmup_steps=1, decay_steps=6,
                                      moment_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_adamw_matches_reference_over_steps(name):
    """Four steps from one state: params, both moments, the step and the
    metrics within 1e-5 (the grads are large enough that clipping acts
    in "default" and "clipping")."""
    rcfg = CFGS[name]
    cfg = optimizer.OptConfig(**rcfg.__dict__)
    rng = np.random.RandomState(3)
    p0 = _tree(rng)
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_st = ref_opt.init_opt_state(ref_p, rcfg)
    p = _t(p0)
    st = optimizer.init_opt_state(p, cfg)
    assert st["m"]["w"].dtype == getattr(torch, rcfg.moment_dtype)
    for _ in range(4):
        g = _tree(rng, scale=3.0)
        ref_p, ref_st, ref_m = ref_opt.adamw_update(
            ref_p, {k: jnp.asarray(v) for k, v in g.items()}, ref_st, rcfg)
        m = optimizer.adamw_update(p, _t(g), st, cfg)
        for k in SHAPES:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(ref_p[k]),
                                       rtol=0, atol=OPT_TOL)
            for mom in ("m", "v"):
                np.testing.assert_allclose(_np(st[mom][k]),
                                           _np(ref_st[mom][k]), rtol=1e-5,
                                           atol=1e-7)
        for key in ("lr", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                       rtol=1e-6)
        assert int(st["step"]) == int(ref_st["step"])


@pytest.mark.parametrize("step", [0, 1, 2, 10, 55, 110, 200])
def test_schedule_matches_reference(step):
    rcfg = ref_opt.OptConfig(lr=1.0, warmup_steps=10, decay_steps=110,
                             min_lr_ratio=0.1)
    cfg = optimizer.OptConfig(**rcfg.__dict__)
    np.testing.assert_allclose(float(optimizer.schedule(cfg, step)),
                               float(ref_opt.schedule(rcfg,
                                                      jnp.asarray(step))),
                               rtol=1e-6, atol=1e-7)


def test_decay_mask_and_global_norm_match_reference():
    rng = np.random.RandomState(4)
    tree = _tree(rng)
    ref = ref_opt._decay_mask({k: jnp.asarray(v) for k, v in tree.items()})
    assert optimizer._decay_mask(_t(tree)) == dict(ref)
    np.testing.assert_allclose(
        float(optimizer.global_norm(_t(tree).values())),
        float(ref_opt.global_norm({k: jnp.asarray(v)
                                   for k, v in tree.items()})), rtol=1e-6)


def test_weight_decay_masked_and_clip_metrics():
    """tests/test_substrate.py:54-79 on the port."""
    cfg = optimizer.OptConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5,
                              clip_norm=0.0)
    p = {"w": torch.ones(2, 2), "scale": torch.ones(2)}
    optimizer.adamw_update(p, {"w": torch.zeros(2, 2),
                               "scale": torch.zeros(2)},
                           optimizer.init_opt_state(p, cfg), cfg)
    assert float(p["w"][0, 0]) < 1.0 and float(p["scale"][0]) == 1.0
    cfg = optimizer.OptConfig(lr=0.0, clip_norm=1.0, weight_decay=0.0)
    p = {"w": torch.zeros(3)}
    m = optimizer.adamw_update(p, {"w": torch.tensor([3.0, 4.0, 0.0])},
                               optimizer.init_opt_state(p, cfg), cfg)
    assert abs(float(m["grad_norm"]) - 5.0) < 1e-5
    assert abs(float(m["clip_scale"]) - 0.2) < 1e-5


def test_adamw_converges_quadratic():
    cfg = optimizer.OptConfig(lr=0.1, warmup_steps=0, decay_steps=10 ** 9,
                              weight_decay=0.0)
    p = {"w": torch.tensor([5.0, -3.0])}
    st = optimizer.init_opt_state(p, cfg)
    for _ in range(200):
        optimizer.adamw_update(p, {"w": 2 * p["w"]}, st, cfg)
    assert float(p["w"].abs().max()) < 0.05


# --------------------------------------------------------------------------
# chunked cross-entropy
# --------------------------------------------------------------------------

CE_CASES = {
    "plain": {},
    "padding": {"pad": True},
    "softcap": {"softcap": 3.0},
    "z_loss": {"z_loss": 1e-3},
    "label_smoothing": {"label_smoothing": 0.1},
    "all": {"pad": True, "softcap": 3.0, "z_loss": 1e-3,
            "label_smoothing": 0.1},
}


@pytest.mark.parametrize("name", sorted(CE_CASES))
def test_chunked_ce_value_metrics_and_grads_match_reference(name):
    """Loss within rtol 1e-5, the metrics, and the gradients with respect
    to ``hidden`` and ``head_w`` (``jax.grad``) within 1e-5 of max|ref|."""
    opts = dict(CE_CASES[name])
    pad = opts.pop("pad", False)
    rng = np.random.RandomState(5)
    b, s, d, v = 2, 16, 8, 50
    hidden = rng.randn(b, s, d).astype(np.float32)
    head = rng.randn(d, v).astype(np.float32)
    labels = rng.randint(0, v, (b, s)).astype(np.int32)
    if pad:
        labels[0, 11:] = -1
        labels[1, 3:6] = -1

    def ref_loss(h, w):
        return ref_ce(h, jnp.asarray(labels), w, n_chunks=4, **opts)

    (loss, met), (gh, gw) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                                jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(head).requires_grad_()
    got, got_met = chunked_cross_entropy(h, torch.from_numpy(labels), w,
                                         n_chunks=4, **opts)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss),
                               rtol=CE_TOL)
    assert int(got_met["n_tokens"]) == int(met["n_tokens"])
    np.testing.assert_allclose(float(got_met["nll"]), float(met["nll"]),
                               rtol=CE_TOL)
    np.testing.assert_allclose(float(got_met["accuracy"]),
                               float(met["accuracy"]), rtol=CE_TOL)
    for g, want in ((h.grad, gh), (w.grad, gw)):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=CE_TOL * np.abs(want).max())


def test_chunked_ce_checkpointed_chunks_equal_plain():
    """The per-chunk checkpoint (taken under autograd) changes no value:
    the loss with grad on equals the loss under no_grad, bitwise."""
    rng = np.random.RandomState(6)
    hidden = torch.from_numpy(rng.randn(2, 12, 8).astype(np.float32))
    head = torch.from_numpy(rng.randn(8, 40).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 40, (2, 12)).astype(np.int32))
    with torch.no_grad():
        plain, _ = chunked_cross_entropy(hidden, labels, head, n_chunks=3)
    remat, _ = chunked_cross_entropy(hidden.clone().requires_grad_(),
                                     labels, head, n_chunks=3)
    assert torch.equal(plain, remat.detach())


def test_chunked_ce_ignores_padding():
    rng = np.random.RandomState(0)
    hidden = torch.from_numpy(rng.randn(1, 8, 4).astype(np.float32))
    head = torch.from_numpy(rng.randn(4, 10).astype(np.float32))
    labels = torch.tensor([[1, 2, 3, -1, -1, -1, -1, -1]], dtype=torch.int32)
    _, metrics = chunked_cross_entropy(hidden, labels, head, n_chunks=2)
    assert int(metrics["n_tokens"]) == 3


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 7])
def test_dataset_batch_at_bitwise_reference(step):
    extra = {"frames": ((5, 3), np.float32)}
    ref = ref_data.SyntheticDataset(1000, 16, 4, seed=3, extra=extra)
    got = data.SyntheticDataset(1000, 16, 4, seed=3, extra=extra)
    want, have = ref.batch_at(step), got.batch_at(step)
    assert set(want) == set(have) == {"tokens", "frames"}
    for k in want:
        assert have[k].dtype == want[k].dtype
        np.testing.assert_array_equal(have[k], want[k])


def test_dataset_on_device_and_iteration():
    ds = data.SyntheticDataset(100, 8, 2, device="cpu", start_step=2)
    b = next(ds)
    assert isinstance(b["tokens"], torch.Tensor)
    assert tuple(b["tokens"].shape) == (2, 9) and ds.step == 3
    np.testing.assert_array_equal(
        b["tokens"].numpy(), ref_data.SyntheticDataset(100, 8, 2)
        .batch_at(2)["tokens"])


def test_prefetcher_order_and_stop():
    items = [{"i": i} for i in range(5)]
    pf = data.Prefetcher(iter(items), depth=2)
    assert [next(pf)["i"] for _ in range(5)] == list(range(5))
    with pytest.raises(StopIteration):
        next(pf)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _mixed_tree(rng):
    return {"a": rng.randn(2, 3).astype(np.float32),
            "nested": {"b": rng.randn(4).astype(np.float32),
                       "i": rng.randint(-9, 9, (3,)).astype(np.int32)},
            "li": [rng.randn(2).astype(np.float32),
                   rng.randn(3).astype(np.float32)]}


def _port_tree(tree):
    """The mixed tree as tensors, ``nested.b`` in bf16."""
    out = {"a": torch.from_numpy(tree["a"]),
           "nested": {"b": torch.from_numpy(tree["nested"]["b"]).to(
               torch.bfloat16), "i": torch.from_numpy(tree["nested"]["i"])},
           "li": [torch.from_numpy(x) for x in tree["li"]]}
    return out


def _ref_tree(tree):
    return {"a": jnp.asarray(tree["a"]),
            "nested": {"b": jnp.asarray(tree["nested"]["b"], jnp.bfloat16),
                       "i": jnp.asarray(tree["nested"]["i"])},
            "li": [jnp.asarray(x) for x in tree["li"]]}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16).view(np.int16) if x.dtype.name == "bfloat16" \
        else x


def _assert_bitwise(got, want):
    for path in (("a",), ("nested", "b"), ("nested", "i"), ("li", 0),
                 ("li", 1)):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_checkpoint_written_by_reference_restores_bitwise(tmp_path):
    tree = _mixed_tree(np.random.RandomState(7))
    ref_ckpt.CheckpointManager(str(tmp_path), async_write=False).save(
        3, _ref_tree(tree))
    got = checkpoint.CheckpointManager(str(tmp_path)).restore(
        _port_tree(tree))
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert got["nested"]["i"].dtype == torch.int32
    _assert_bitwise(got, _port_tree(tree))


def test_checkpoint_written_by_port_restores_bitwise_in_reference(tmp_path):
    tree = _mixed_tree(np.random.RandomState(8))
    checkpoint.CheckpointManager(str(tmp_path), async_write=False).save(
        4, _port_tree(tree))
    got = ref_ckpt.CheckpointManager(str(tmp_path)).restore(_ref_tree(tree))
    assert got["nested"]["b"].dtype == jnp.bfloat16
    _assert_bitwise(got, _ref_tree(tree))


def test_checkpoint_roundtrip_module_and_tensors(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2,
                                       async_write=False)
    model = torch.nn.Linear(3, 2)
    tree = {"params": model,
            "opt": {"step": torch.tensor(5, dtype=torch.int32),
                    "m": {"w": torch.ones(4, dtype=torch.bfloat16)}}}
    mgr.save(10, tree)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    out = mgr.restore({"params": model, "opt": {
        "step": torch.zeros((), dtype=torch.int32),
        "m": {"w": torch.zeros(4, dtype=torch.bfloat16)}}})
    assert out["params"] is model
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k])
    assert int(out["opt"]["step"]) == 5
    assert out["opt"]["m"]["w"].dtype == torch.bfloat16
    manifest = (tmp_path / "step_10" / "manifest.json").read_text()
    assert '"params/weight"' in manifest and '"opt/m/w"' in manifest


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2,
                                       async_write=False)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((1,), float(s))})
    assert mgr.all_steps() == [2, 3]
    assert float(mgr.restore({"x": torch.zeros(1)})["x"][0]) == 3.0


def test_checkpoint_async_copies_before_returning(tmp_path):
    """The write runs on a thread, but from a copy taken before ``save``
    returns: an in-place update right after it does not reach the file."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=1,
                                       async_write=True)
    x = torch.ones(4)
    mgr.save(5, {"x": x})
    x.add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore({"x": x})["x"], torch.ones(4))


def test_checkpoint_shape_mismatch(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"x": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"x": torch.ones(5)})


# --------------------------------------------------------------------------
# fault tolerance
# --------------------------------------------------------------------------

STEP_TIMES = [0.1, 0.11, 0.09, 0.1, 0.1, 0.1, 0.12, 0.1, 3.0, 0.1, 0.1,
              0.5, 0.1, 0.1, 0.09, 1.5, 0.1, 0.1]


def test_straggler_monitor_flags_the_reference_steps(monkeypatch):
    """One injected sequence of step times (a fake monotonic clock): the
    port flags the steps the reference flags, with the same z-scores."""
    clock = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])

    def run(mod):
        clock[0] = 0.0
        mon = mod.StragglerMonitor(z_threshold=3.0, warmup_steps=3)
        out = []
        for i, dt in enumerate(STEP_TIMES):
            mon.start_step()
            clock[0] += dt
            st = mon.end_step(i)
            out.append((st.step, st.is_straggler, st.z_score))
        return out, [s.step for s in mon.flagged]

    ref, ref_flags = run(ref_fault)
    got, got_flags = run(fault)
    assert got_flags == ref_flags and ref_flags
    for (s, f, z), (rs, rf, rz) in zip(got, ref):
        assert (s, f) == (rs, rf)
        assert z == pytest.approx(rz, rel=1e-12)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("prefer_model", [16, 2])
def test_elastic_mesh_shape_rule_matches_reference(n, prefer_model,
                                                   monkeypatch):
    seen = {}
    monkeypatch.setattr(jax, "devices", lambda: [None] * n)
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, names, **kw: seen.update(shape=shape))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    ref_fault.elastic_mesh(prefer_model=prefer_model)
    shape, mesh = fault.elastic_mesh(prefer_model=prefer_model)
    assert shape == tuple(seen["shape"]) and mesh is None


def test_preemption_handler_flag():
    h = fault.PreemptionHandler()
    assert not h.preemption_requested
    h._handle(15, None)
    assert h.preemption_requested
