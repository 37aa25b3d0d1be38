"""Training on the port (``lm.loss_fn``, the B1/B2 autograd ops, the train
step, the driver) against the JAX package's, on the CPU.

* Loss and every parameter's gradient against ``jax.value_and_grad`` of
  the reference's ``lm.loss_fn`` at float32, on one smoke config of each
  family (qwen3, the moonshot MoE with its load-balancing loss, mamba2,
  hymba, whisper) and on a qwen3 whose ``vocab_size`` (500) lies below
  ``padded_vocab`` (512), which the smoke configs' 512 hides: the loss
  within ``LOSS_RTOL``, each gradient within ``GRAD_TOL`` of its leaf's
  largest magnitude (the frameworks sum float32 in other orders).
* ``make_train_step`` with ``microbatches=2`` against the reference's: the
  loss, the gradient norm and, after one AdamW step, both moments (the
  accumulated, clipped gradient) and every parameter.
* ``remat`` "none", "dots" and "full": the loss and the gradients equal
  bit for bit, on every family.
* B1's and B2's autograd ops (``kernels/autograd.py``, their plain
  versions here) against autograd through the plain ops
  (``ref.matmul_fused_ref`` for every epilogue, ``ref.attention_ref``
  for GQA groups, windows and a valid length) within 1e-6.
* Port against port, twins of ``tests/test_runtime_integration.py``: the
  loss decreases over 30 steps (``:25``), a crash and resume is bit-exact
  (``:41``), stragglers are flagged (``:61``); the ``train.step`` site and
  ``REPRO_FAIL_AT_STEP``; the launcher with ``--resume``.
* One train step of every config's smoke size, the twin of
  ``tests/test_arch_smoke.py:14``; ``bench/smoke_diff.py``, which holds a
  chip run's served tokens and launch counts against another's.

Weights are drawn with seeded numpy and cross over through
``models.bridge.params_from_numpy``; the JAX gradients cross over the same
way.  The JAX package is imported inside the tests that use it.

On the card (marker ``card``, skipped here): B1's and B2's gradients on
the kernels against autograd through the plain ops; B3, B9, B1 on packed
weights (B6) and B8 refuse an operand that requires grad, so no gradient
is ever dropped in silence.  Those tests import no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m card \
        tests/test_torch_train.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import _build, ops, pack, ref
from repro_torch.models import bridge, lm
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import leaves
from repro_torch.runtime import health
from repro_torch.runtime.driver import TrainDriver, TrainJobConfig
from repro_torch.train import step as tstep

LOSS_RTOL = 1e-5
GRAD_TOL = 5e-5            # of the leaf's largest |gradient|
AUTOGRAD_TOL = dict(atol=1e-6, rtol=1e-6)
FAMILIES = {"qwen3": ("qwen3-1.7b", ()),
            "moonshot": ("moonshot-v1-16b-a3b", ()),
            "mamba2": ("mamba2-780m", ()),
            "hymba": ("hymba-1.5b", ()),
            "whisper": ("whisper-tiny", ()),
            "qwen3_vocab500": ("qwen3-1.7b", (("vocab_size", 500),))}
NORMS = {"ln1", "ln2", "ln_cross", "final_norm", "q_norm", "k_norm", "norm"}


def _cfgs(case: str):
    from repro import configs as jconfigs

    name, changes = FAMILIES[case]
    return (dataclasses.replace(configs.get_smoke(name), **dict(changes)),
            dataclasses.replace(jconfigs.get_smoke(name), **dict(changes)))


def _numpy_params(cfg, seed: int = 0):
    """A parameter tree in the JAX package's layout, drawn with numpy:
    norm scales near 1, matrices N(0, 1/fan_in), embeddings N(0, 1/d),
    vectors N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, shape in bridge.expected_shapes(cfg).items():
        own = shape[1:] if "layers" in path else shape
        x = rng.standard_normal(shape)
        if path[-1] in NORMS:
            x = 1 + 0.1 * x
        elif path[-1] == "table":
            x = x * shape[-1] ** -0.5
        elif len(own) >= 2:
            x = x * own[-2] ** -0.5
        else:
            x = 0.1 * x
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x.astype(np.float32)
    return tree


def _batch(cfg, b: int = 2, s: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
               np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(
               np.int32)}
    if cfg.is_encoder_decoder:
        out["enc_frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _jax_tree(tree):
    import jax.numpy as jnp

    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _as_port(tree, cfg):
    import jax

    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), cfg,
                                    device="cpu")


def _grads_close(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        bound = GRAD_TOL * float(w.abs().max()) + 1e-12
        err = float((g - w).abs().max())
        assert err <= bound, (path, err, bound)


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_loss_and_gradients_match_jax(case):
    import jax

    from repro.models import lm as jlm

    cfg, jcfg = _cfgs(case)
    tree, batch = _numpy_params(cfg), _batch(cfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg, remat="none"), has_aux=True))(
        _jax_tree(tree), _jax_tree(batch))
    loss, metrics, grads = tstep.value_and_grad(
        tstep.make_loss_fn(cfg, "none"), bridge.params_from_numpy(
            tree, cfg, device="cpu"), _torch_batch(batch))
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(metrics["nll"]) == pytest.approx(float(jmetrics["nll"]),
                                                  rel=LOSS_RTOL)
    assert float(metrics["aux"]) == pytest.approx(
        float(jmetrics["aux"]), rel=LOSS_RTOL, abs=1e-7)
    if cfg.n_experts:
        assert float(metrics["aux"]) > 0
    _grads_close(grads, _as_port(jgrads, cfg))


def test_padded_vocab_is_masked_in_the_loss():
    """Logits past vocab_size are -inf: the loss is the NLL over the
    first vocab_size entries alone (and their gradient reaches no padded
    row of the table but through the hidden states)."""
    cfg, _ = _cfgs("qwen3_vocab500")
    params = bridge.params_from_numpy(_numpy_params(cfg), cfg, device="cpu")
    batch = _torch_batch(_batch(cfg))
    x, _ = lm.forward_hidden(params, batch["tokens"], cfg)
    logits = (x @ params["embed"]["table"].T).float()[..., :cfg.vocab_size]
    want = (torch.logsumexp(logits, -1) - logits.gather(
        -1, batch["targets"].long()[..., None])[..., 0]).mean()
    got = lm.chunked_cross_entropy(x, params["embed"]["table"],
                                   batch["targets"], cfg, chunk=5)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_microbatched_train_step_matches_jax():
    import jax

    from repro.models import lm as jlm  # noqa: F401  (the step imports it)
    from repro.optim import AdamW as JaxAdamW
    from repro.train.step import make_train_step as jmake

    cfg, jcfg = _cfgs("qwen3")
    tree, batch = _numpy_params(cfg), _batch(cfg, b=4)
    jopt = JaxAdamW(lr_fn=lambda _: 1e-2)
    jp = _jax_tree(tree)
    jp, jstate, jm = jax.jit(jmake(jcfg, jopt, remat="none",
                                   microbatches=2))(
        jp, jopt.init(jp), _jax_tree(batch))
    opt = AdamW(lr_fn=lambda _: 1e-2)
    params = bridge.params_from_numpy(tree, cfg, device="cpu")
    params, state, m = tstep.make_train_step(
        cfg, opt, remat="none", microbatches=2)(
        params, opt.init(params), _torch_batch(batch))
    assert state.step == int(jstate.step) == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)
    # after one step the moments are (1 - b1) g and (1 - b2) g^2 of the
    # accumulated gradient g, clipped to norm 1
    _grads_close(state.m, _as_port(jstate.m, cfg))
    _grads_close(state.v, _as_port(jstate.v, cfg))
    # Adam moves each parameter by about lr whatever its gradient's size,
    # so a gradient within a few ulps of 0 may move it anywhere in that
    # range: the parameters agree to one step, the moments above say more
    want = dict(leaves(_as_port(jp, cfg)))
    for path, p in leaves(params):
        np.testing.assert_allclose(p.numpy(), want[path].numpy(), atol=1e-2,
                                   rtol=0, err_msg=str(path))


# ---------------------------------------------------------------------------
# Port against port.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["qwen3", "moonshot", "mamba2", "hymba",
                                  "whisper"])
def test_remat_modes_are_equal_bit_for_bit(case):
    cfg = configs.get_smoke(FAMILIES[case][0])
    params = bridge.params_from_numpy(_numpy_params(cfg, 1), cfg,
                                      device="cpu")
    batch = _torch_batch(_batch(cfg, seed=1))
    runs = {r: tstep.value_and_grad(tstep.make_loss_fn(cfg, r), params,
                                    batch) for r in lm.REMAT}
    loss, _, grads = runs["none"]
    for r in ("dots", "full"):
        assert torch.equal(runs[r][0], loss), r
        for (path, a), (_, b) in zip(leaves(runs[r][2]), leaves(grads)):
            assert torch.equal(a, b), (r, path)
    with pytest.raises(ValueError, match="remat"):
        tstep.value_and_grad(tstep.make_loss_fn(cfg, "some"), params, batch)


def _tracked(*tensors):
    return [t.detach().clone().requires_grad_() for t in tensors]


@pytest.mark.parametrize("activation", [None, "silu", "gelu", "relu"])
@pytest.mark.parametrize("epilogue", ["none", "bias", "residual", "both"])
def test_b1_backward_matches_autograd_through_the_plain_op(activation,
                                                          epilogue):
    gen = torch.Generator().manual_seed(0)
    a, w = torch.randn(37, 24, generator=gen), torch.randn(24, 40,
                                                           generator=gen)
    bias = torch.randn(40, generator=gen) if epilogue in ("bias", "both") \
        else None
    res = torch.randn(37, 40, generator=gen) \
        if epilogue in ("residual", "both") else None
    g = torch.randn(37, 40, generator=gen)
    ins = [t for t in (a, w, bias, res) if t is not None]
    ours, plain = _tracked(*ins), _tracked(*ins)

    def call(fn, ts):
        it = iter(ts)
        x, y = next(it), next(it)
        bb = next(it) if bias is not None else None
        rr = next(it) if res is not None else None
        if fn is ref.matmul_fused_ref and bb is not None:
            bb = bb.reshape(1, -1)
        return fn(x, y, bias=bb, residual=rr, activation=activation)

    out = call(ops.matmul_fused, ours)
    assert "matmul_fused" in type(out.grad_fn).__name__
    want = call(ref.matmul_fused_ref, plain)
    assert torch.equal(out, want)
    for got, exp in zip(torch.autograd.grad(out, ours, g),
                        torch.autograd.grad(want, plain, g)):
        torch.testing.assert_close(got, exp, **AUTOGRAD_TOL)
    # bf16 operands: the gradients come back in the operands' dtype
    a16, w16 = _tracked(a.bfloat16(), w.bfloat16())
    out = ops.matmul_fused(a16, w16, activation=activation)
    ga, gw = torch.autograd.grad(out, (a16, w16), g)
    assert ga.dtype == gw.dtype == torch.bfloat16


@pytest.mark.parametrize("hq,hkv,sq,skv,window,kv_len", [
    (4, 4, 16, 16, None, None), (4, 2, 16, 16, 5, None),
    (6, 2, 9, 9, None, None), (4, 1, 3, 20, None, 12),
    (4, 2, 7, 7, 3, 7)])
def test_b2_backward_matches_autograd_through_the_plain_op(hq, hkv, sq, skv,
                                                          window, kv_len):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, hq, sq, 16, generator=gen)
    k, v = (torch.randn(2, hkv, skv, 16, generator=gen) for _ in range(2))
    g = torch.randn(2, hq, sq, 16, generator=gen)
    ours, plain = _tracked(q, k, v), _tracked(q, k, v)
    kw = dict(causal=True, window=window, kv_len=kv_len)
    out = ops.attention(*ours, **kw)
    assert "attention" in type(out.grad_fn).__name__
    want = ref.attention_ref(*plain, **kw)
    assert torch.equal(out, want)
    for got, exp in zip(torch.autograd.grad(out, ours, g),
                        torch.autograd.grad(want, plain, g)):
        torch.testing.assert_close(got, exp, **AUTOGRAD_TOL)


def test_grad_paths_refuse_what_they_cannot_carry():
    a, w = _tracked(torch.randn(4, 8), torch.randn(8, 4))
    with pytest.raises(NotImplementedError, match="spec=None"):
        ops.matmul_fused(a, w, spec=ops.matmul_df.BASIC_OS)
    with pytest.raises(NotImplementedError, match="scale"):
        ops.matmul_fused(a.detach(), w.detach(),
                         scale=torch.ones(1, requires_grad=True))
    q, k, v = _tracked(*(torch.randn(2, 2, 4, 16) for _ in range(3)))
    with pytest.raises(NotImplementedError, match="per-row"):
        ops.attention(q, k, v, kv_len=torch.tensor([2, 4]))
    # a kernel launch with an operand that requires grad is refused
    with pytest.raises(NotImplementedError, match="no backward"):
        _build.refuse_grad("paged_attention", q)
    with torch.no_grad():
        _build.refuse_grad("paged_attention", q)
    _build.refuse_grad("paged_attention", q.detach())


def _job(tmp, **kw):
    base = dict(arch=configs.get_smoke("qwen3-1.7b"), steps=10,
                global_batch=4, seq_len=32, ckpt_dir=str(tmp),
                ckpt_every=4, lr=1e-3)
    base.update(kw)
    return TrainJobConfig(**base)


def test_training_loss_decreases(tmp_path):
    job = _job(tmp_path, steps=30, seq_len=64, lr=3e-3)
    driver = TrainDriver(job, device="cpu")
    state = driver.init_state()
    losses = []
    for step in range(job.steps):
        params, opt, metrics = driver._step_fn(
            state.params, state.opt_state, driver.dataset.batch(step, "cpu"))
        losses.append(float(metrics["loss"]))
        state = type(state)(step + 1, params, opt, losses[-1])
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_crash_resume_bit_exact(tmp_path, monkeypatch):
    ref_state = TrainDriver(_job(tmp_path / "a"), device="cpu").run()
    job = _job(tmp_path / "b")
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "6")
    crashed = TrainDriver(job, device="cpu")
    with pytest.raises(health.SimulatedFailure):
        crashed.run()
    assert [e.step for e in crashed.monitor.events_of("fault")] == [6]
    assert crashed.ckpt.latest_step() == 4
    monkeypatch.delenv("REPRO_FAIL_AT_STEP")
    driver = TrainDriver(job, device="cpu")
    resumed = driver.run(resume=True)
    assert resumed.step == ref_state.step == 10
    assert resumed.last_loss == ref_state.last_loss
    assert driver.ckpt.latest_step() == 10
    for (path, a), (_, b) in zip(leaves(ref_state.params),
                                 leaves(resumed.params)):
        assert torch.equal(a, b), path
    for tree in ("m", "v"):
        for (path, a), (_, b) in zip(
                leaves(getattr(ref_state.opt_state, tree)),
                leaves(getattr(resumed.opt_state, tree))):
            assert torch.equal(a, b), (tree, path)
    assert resumed.opt_state.step == 10
    report = driver.health_report()
    assert report["steps"] == 6 and report["stragglers"] == 0


def test_straggler_detection():
    mon = health.HealthMonitor(window=16, threshold=2.0)
    assert not any(mon.record(i, 0.1) for i in range(20))
    assert mon.record(20, 1.0)
    assert len(mon.stragglers) == 1


def test_train_step_site_and_fail_at_step(monkeypatch):
    assert "train.step" in health.INJECTION_SITES
    health.reset_faults()
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "3")
    health.maybe_inject_failure(2)
    with pytest.raises(health.SimulatedFailure, match="step 3"):
        health.maybe_inject_failure(3)
    monkeypatch.delenv("REPRO_FAIL_AT_STEP")
    monkeypatch.setenv("REPRO_FAULT_PLAN", "train.step:5:raise")
    health.maybe_inject_failure(4)
    with pytest.raises(health.SimulatedFailure):
        health.maybe_inject_failure(5)
    assert [(f.site, f.hit) for f in health.fault_log()] == [
        ("train.step", 3), ("train.step", 5)]
    health.reset_faults()


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys,
                                               monkeypatch):
    from repro_torch.launch import train

    argv = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--steps",
            "6", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path), "--remat", "full"]
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "3")
    with pytest.raises(health.SimulatedFailure):
        train.main(argv)
    monkeypatch.delenv("REPRO_FAIL_AT_STEP")
    train.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "final step=6" in out


def test_smoke_diff_compares_tokens_and_launches(tmp_path, capsys):
    """``bench/smoke_diff.py``, which holds the serve phases' tokens and
    launch counts against another run's log: equal logs pass; a changed
    token, a changed count or a missing event fails."""
    import json

    from repro_torch.bench import smoke_diff

    def log(name, tokens, launches, extra=()):
        path = tmp_path / name
        rows = [{"phase": "serve", "event": "drain", "tokens": tokens,
                 "launches": launches},
                {"phase": "serve", "event": "done",
                 "launches_by_path": launches}, *extra]
        path.write_text("noise\n" + "\n".join(json.dumps(r) for r in rows))
        return str(path)

    base = log("a", [[1, 2]], {"matmul_os": 3})
    assert smoke_diff.main([base, log("b", [[1, 2]], {"matmul_os": 3})]) == 0
    assert smoke_diff.main([base, log("c", [[1, 3]], {"matmul_os": 3})]) == 1
    assert smoke_diff.main([base, log("d", [[1, 2]], {"matmul_os": 4})]) == 1
    with_more = log("e", [[1, 2]], {"matmul_os": 3},
                    [{"phase": "train", "event": "done",
                      "launches_by_path": {"matmul_os": 9}}])
    assert smoke_diff.main([base, with_more]) == 0
    assert smoke_diff.main([with_more, base]) == 1
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == {"compared": 3, "differ_or_missing": 1, "new_only": 0}


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_smoke_forward_and_train_step(arch):
    """The twin of tests/test_arch_smoke.py:14: logits of the padded
    vocab, finite; one train step with a finite loss and gradient norm
    that moves the parameters; the eval step's loss finite."""
    cfg = configs.get_smoke(arch)
    params = lm.init_model(cfg, seed=0, device="cpu")
    batch = _torch_batch(_batch(cfg, b=2, s=16))
    logits, _ = lm.forward(params, batch["tokens"], cfg,
                           enc_frames=batch.get("enc_frames"), remat="none")
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    before = {p: t.clone() for p, t in leaves(params)}
    opt = AdamW(lr_fn=lambda _: 1e-3)
    params, _, metrics = tstep.make_train_step(cfg, opt, remat="none")(
        params, opt.init(params), batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert any(not torch.equal(before[p], t) for p, t in leaves(params))
    ev = tstep.make_eval_step(cfg)(params, batch)
    assert bool(torch.isfinite(ev["loss"])) and not ev["loss"].requires_grad


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels' gradients and their "
                    "refusals run only there")
    return torch.device("cuda")


# B1's and B2's tolerances on the card (chip_smoke.py's B1_TOL and B2's
# f32 tolerance): float32 math on both sides in other orders.
CARD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.card
@pytest.mark.parametrize("activation", [None, "silu"])
def test_b1_gradients_on_the_card(card, activation):
    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn(137, 256, generator=gen, device=card)
    w = torch.randn(256, 192, generator=gen, device=card) * 256 ** -0.5
    bias = torch.randn(192, generator=gen, device=card)
    g = torch.randn(137, 192, generator=gen, device=card)
    before = dict(_build.LAUNCHES)
    ours, plain = _tracked(a, w, bias), _tracked(a, w, bias)
    out = ops.matmul_fused(*ours[:2], bias=ours[2], activation=activation)
    want = ref.matmul_fused_ref(*plain[:2], bias=plain[2].reshape(1, -1),
                                activation=activation)
    got = torch.autograd.grad(out, ours, g)
    torch.testing.assert_close(out, want, **CARD_TOL)
    for x, y in zip(got, torch.autograd.grad(want, plain, g)):
        torch.testing.assert_close(x, y, **CARD_TOL)
    launched = sum(_build.LAUNCHES[k] - before[k]
                   for k in ("matmul_os", "matmul_rmw", "matmul_ws_stripe",
                             "matmul_is_stripe"))
    assert launched == 3 + (activation is not None)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,s,window", [(4, 2, 100, None),
                                             (5, 1, 70, 16)])
def test_b2_gradients_on_the_card(card, dtype, hq, hkv, s, window):
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn(2, h, s, 64, generator=gen, device=card).to(dtype)
               for h in (hq, hkv, hkv))
    g = torch.randn(2, hq, s, 64, generator=gen, device=card).to(dtype)
    before = _build.LAUNCHES["flash_attention"] \
        + _build.LAUNCHES["kv_stationary"]
    ours, plain = _tracked(q, k, v), _tracked(q, k, v)
    out = ops.attention(*ours, causal=True, window=window)
    want = ref.attention_ref(*plain, causal=True, window=window)
    tol = CARD_TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out, want, **tol)
    for x, y in zip(torch.autograd.grad(out, ours, g),
                    torch.autograd.grad(want, plain, g)):
        torch.testing.assert_close(x, y, **tol)
    assert _build.LAUNCHES["flash_attention"] \
        + _build.LAUNCHES["kv_stationary"] == before + 1


@pytest.mark.card
@pytest.mark.parametrize("kernel", ["paged_attention", "binary_mm",
                                    "packed", "conv2d"])
def test_kernels_without_a_backward_refuse_grad_on_the_card(card, kernel):
    gen = torch.Generator(device=card).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card)

    if kernel == "paged_attention":
        q = randn(2, 4, 1, 64).bfloat16().requires_grad_()
        pages = randn(2, 3, 16, 64).bfloat16()
        call = lambda: ops.paged_attention(  # noqa: E731
            q, pages, pages, torch.zeros((2, 2), dtype=torch.int32,
                                         device=card),
            torch.tensor([5, 16], dtype=torch.int32, device=card))
    elif kernel == "binary_mm":
        a = torch.randint(-2**31, 2**31 - 1, (8, 2), generator=gen,
                          device=card, dtype=torch.int32)
        w = torch.randint(-2**31, 2**31 - 1, (2, 16), generator=gen,
                          device=card, dtype=torch.int32)
        scale = randn(16).requires_grad_()
        call = lambda: ops.binary_matmul_fused(a, w, 64,  # noqa: E731
                                               scale=scale)
    elif kernel == "packed":
        wq = torch.randint(-7, 8, (64, 32), generator=gen, device=card,
                           dtype=torch.int32).to(torch.int8)
        pw = pack.pack_int8(wq, torch.full((1, 32), 0.01, device=card),
                            bits=4)
        aq = torch.randint(-127, 128, (8, 64), generator=gen, device=card,
                           dtype=torch.int32).to(torch.int8)
        bias = randn(32).requires_grad_()
        call = lambda: ops.matmul_packed_fused(  # noqa: E731
            aq, pw, a_scale=torch.tensor(0.02, device=card), bias=bias)
    else:
        x = randn(1, 8, 8, 16).requires_grad_()
        call = lambda: ops.conv2d(x, randn(3, 3, 16, 16))  # noqa: E731
    with pytest.raises(NotImplementedError, match="no backward"):
        call().float().sum().backward()
    with torch.no_grad():
        assert torch.isfinite(call().float()).all()
