"""The port's optimizer, schedules, gradient quantizer and data pipeline
against the JAX package's, on the CPU.

* Schedules (``linear_warmup``, ``wsd``, ``cosine``) at every step of a
  run and past its end, within 2 float32 ulps of the peak rate of the
  reference (the port computes in double precision; the reference, in
  float32, loses digits where ``1 + cos(pi t)`` cancels).
* ``AdamW.update`` from a state the reference built over three steps and
  carried across (params, moments, step), then two more steps on both
  sides, float32 and bfloat16 moments, float32 and bfloat16 parameters,
  the clip engaged and not: parameters and moments within
  ``ADAMW_ULPS`` float32 ulps of each leaf's largest magnitude (bf16
  values within one bf16 ulp of their own), the global norm within 1e-6
  relative.  The
  reference's own properties port against port: convergence on a
  quadratic, clipping, bf16 moments.
* ``quantize_grad`` equal to the reference's codes and scale bit for
  bit, ``dequantize_grad`` equal, and the error bound of
  ``tests/test_optim_data_ckpt.py`` over twenty seeds;
  ``compressed_psum`` and ``make_global_batch`` over a one-rank gloo
  group: the first equal to the JAX package's bit for bit.
* ``SyntheticLMDataset`` equal to the reference's batches bit for bit
  (tokens, targets and an encoder-decoder's frames), stateless and
  step-addressed; ``batch`` gives tensors on the device asked for.

Inputs come from seeded numpy generators and cross over as numpy arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMDataset as JaxDataset
from repro.optim import AdamW as JaxAdamW
from repro.optim import global_norm as jglobal_norm
from repro.optim import compress as jcompress
from repro.optim import schedules as jschedules
from repro_torch.data.pipeline import SyntheticLMDataset, make_global_batch
from repro_torch.optim import AdamW, AdamWState, compress, global_norm
from repro_torch.optim import schedules
from repro_torch.optim.adamw import leaves

# float32 ulps between the port's AdamW and the reference's: the bias
# corrections and the rate are host doubles here and float32 there, and
# the two frameworks may round pow, sqrt and the moment updates apart.
ADAMW_ULPS = 8
SCHEDULE_ULPS = 2


def _ulps_apart(got, want, of) -> float:
    """The largest |got - want| in float32 ulps of ``of``."""
    ulp = np.spacing(np.float32(abs(of)))
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))) / ulp)


# ---------------------------------------------------------------------------
# Schedules.
# ---------------------------------------------------------------------------
CASES = {
    "linear_warmup": [(10, 3e-4), (1, 1.0), (0, 0.5)],
    "wsd": [(10, 60, 20, 3e-3, 0.0), (5, 10, 30, 1.0, 0.05)],
    "cosine": [(10, 100, 1.0, 0.1), (0, 40, 3e-4, 0.0), (5, 5, 2.0, 0.1)],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedules_match_the_reference(name):
    ours, theirs = getattr(schedules, name), getattr(jschedules, name)
    for args in CASES[name]:
        for step in range(0, 130):
            got = ours(step, *args)
            want = np.float32(theirs(step, *args))
            assert isinstance(got, float)
            assert _ulps_apart(got, want, args[-2 if name != "linear_warmup"
                                               else -1]) \
                <= SCHEDULE_ULPS, (name, args, step, got, want)


def test_wsd_phases_and_cosine_decay_port_against_port():
    """The reference's schedule properties (tests/test_optim_data_ckpt.py)."""
    assert schedules.wsd(5, 10, 100, 20, 1.0) < 1.0
    assert schedules.wsd(50, 10, 100, 20, 1.0) == pytest.approx(1.0)
    assert schedules.wsd(125, 10, 100, 20, 1.0) < 1.0
    xs = [schedules.cosine(s, 10, 100, 1.0) for s in range(10, 100, 5)]
    assert all(a >= b - 1e-6 for a, b in zip(xs, xs[1:]))


# ---------------------------------------------------------------------------
# AdamW.
# ---------------------------------------------------------------------------
SHAPES = {"a": (4, 8), "nested": {"b": (16,), "c": (3, 5)}}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def draw(shapes):
        return {k: draw(v) if isinstance(v, dict)
                else (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in shapes.items()}

    return draw(SHAPES)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _torch_tree(tree, dtype):
    return _map(lambda a: torch.tensor(np.asarray(a, np.float32)).to(dtype),
                tree)


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy()) if torch.is_tensor(t) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _check_close(got_tree, want_tree, dtype):
    got = dict(leaves(got_tree))
    want = {p: w for p, w in leaves(_torch_tree(
        jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
                     want_tree), torch.float32))}
    assert got.keys() == want.keys()
    for path, g in got.items():
        g, w = _np(g), _np(want[path])
        if dtype == torch.bfloat16:
            # two roundings to bf16 of float32 values a few ulps apart
            ulp = np.spacing(np.abs(w).astype(np.float32)) * 2 ** 16
            assert np.all(np.abs(g - w) <= ulp + 1e-30), path
        else:
            ulps = _ulps_apart(g, w, np.abs(w).max())
            assert ulps <= ADAMW_ULPS, (path, ulps)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])     # clip off / on
def test_adamw_update_from_a_carried_jax_state(moments, param_dtype,
                                               grad_scale):
    lr = lambda s: 1e-2 * (1 + s) / 4       # noqa: E731  a rate that moves
    jopt = JaxAdamW(lr_fn=lambda s: 1e-2 * (1 + s) / 4, moment_dtype=moments)
    opt = AdamW(lr_fn=lr, moment_dtype=moments)
    jdt = jnp.float32 if param_dtype == torch.float32 else jnp.bfloat16
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(0))
    state = jopt.init(jp)
    for i in range(3):
        grads = jax.tree.map(lambda a: jnp.asarray(a, jdt),
                             _tree(10 + i, grad_scale))
        jp, state, _ = jopt.update(grads, state, jp)
    # carry the reference's params and state across
    mdt = getattr(torch, moments)
    tp = _torch_tree(jax.tree.map(lambda x: np.asarray(
        jnp.asarray(x, jnp.float32)), jp), param_dtype)
    tstate = AdamWState(int(state.step), *(
        _torch_tree(jax.tree.map(lambda x: np.asarray(
            jnp.asarray(x, jnp.float32)), t), mdt) for t in (state.m,
                                                             state.v)))
    for i in range(2):
        g_np = _tree(20 + i, grad_scale)
        jp, state, jm = jopt.update(
            jax.tree.map(lambda a: jnp.asarray(a, jdt), g_np), state, jp)
        tp, tstate, tm = opt.update(_torch_tree(g_np, param_dtype), tstate,
                                    tp)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert tstate.step == int(state.step) == 5
    _check_close(tp, jp, param_dtype)
    for got, want in ((tstate.m, state.m), (tstate.v, state.v)):
        _check_close(got, want, mdt)
    assert all(t.dtype == param_dtype for _, t in leaves(tp))
    assert all(t.dtype == mdt for _, t in leaves(tstate.m))


def test_adamw_updates_in_place():
    opt = AdamW(lr_fn=lambda _: 0.1)
    params = _torch_tree(_tree(0), torch.float32)
    state = opt.init(params)
    ptrs = [t.data_ptr() for _, t in leaves(params)]
    new, new_state, _ = opt.update(_torch_tree(_tree(1), torch.float32),
                                   state, params)
    assert new is params and new_state.m is state.m
    assert [t.data_ptr() for _, t in leaves(new)] == ptrs
    assert new_state.step == 1 and state.step == 0


def test_global_norm_matches_the_reference():
    tree = _tree(3, 5.0)
    want = float(jglobal_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(global_norm(_torch_tree(tree, torch.float32)))
    assert got == pytest.approx(want, rel=1e-6)


def test_adamw_converges_clips_and_keeps_bf16_moments():
    """The reference's AdamW properties (tests/test_optim_data_ckpt.py),
    port against port."""
    opt = AdamW(lr_fn=lambda _: 0.1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        g, = torch.autograd.grad(((w - 1.0) ** 2).sum(), w)
        params, state, _ = opt.update({"w": g}, state, params)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0], atol=1e-2)

    opt = AdamW(lr_fn=lambda _: 0.1, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    _, _, metrics = opt.update({"w": torch.tensor([100.0, 0.0, 0.0])},
                               opt.init(params), params)
    assert float(metrics["grad_norm"]) > 99.0
    assert float(params["w"].abs().max()) <= 0.1 + 1e-6   # one lr step

    opt = AdamW(lr_fn=lambda _: 0.1, moment_dtype="bfloat16")
    params = {"w": torch.ones(4)}
    state = opt.init(params)
    assert state.m["w"].dtype == torch.bfloat16
    _, s2, _ = opt.update({"w": torch.ones(4)}, state, params)
    assert s2.m["w"].dtype == torch.bfloat16
    assert bool((params["w"] < 1).all())


# ---------------------------------------------------------------------------
# Gradient quantization.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(20))
def test_quantize_grad_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(64,)) * rng.uniform(0.1, 10)).astype(np.float32)
    if seed == 0:
        g[:] = 0.0                      # amax 0: scale 1, dequant exact
    q, scale = compress.quantize_grad(torch.from_numpy(g))
    jq, jscale = jcompress.quantize_grad(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    deq = compress.dequantize_grad(q, scale)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jcompress.dequantize_grad(jq, jscale)))
    # the reference's bound (tests/test_optim_data_ckpt.py)
    assert float((deq - torch.from_numpy(g)).abs().max()) \
        <= float(scale) / 2 + 1e-6


# The test keeps the name it had while these collectives were refused.
def test_collectives_name_a14(tmp_path):
    """The multi-device collectives over a one-rank gloo group
    (created and destroyed here): ``compressed_psum`` equals the JAX
    package's on one device (its ``shard_map`` over a 1-device mesh), bit
    for bit, residuals included; ``make_global_batch`` on a 1x1 mesh
    holds the whole batch."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import sharding
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        g = np.random.default_rng(3).normal(size=(2, 32)).astype(np.float32)
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        red, res = compress.compressed_psum({"g": torch.from_numpy(g[0])},
                                            (mesh, 0))
        red2, res2 = compress.compressed_psum(
            {"g": torch.from_numpy(g[1])}, (mesh, 0), res)

        def run(g0, g1):
            r0, s0 = jcompress.compressed_psum({"g": g0}, "dp")
            r1, s1 = jcompress.compressed_psum({"g": g1}, "dp", s0)
            return r0["g"], s0["g"], r1["g"], s1["g"]

        P = jax.sharding.PartitionSpec
        want = jax.shard_map(run, mesh=jax.make_mesh((1,), ("dp",)),
                             in_specs=(P(), P()), out_specs=(P(),) * 4)(
            jnp.asarray(g[0]), jnp.asarray(g[1]))
        for got, w in zip((red["g"], res["g"], red2["g"], res2["g"]), want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        ds = SyntheticLMDataset(vocab_size=100, seq_len=16, global_batch=4,
                                seed=7)
        np_batch = ds.batch_np(2)
        shs = sharding.batch_shardings(np_batch, mesh)
        got = make_global_batch(np_batch["tokens"], shs["tokens"], "cpu")
        np.testing.assert_array_equal(got.to_local().numpy(),
                                      np_batch["tokens"])
        assert got.shape == np_batch["tokens"].shape
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=16, global_batch=4, seed=7),
    dict(vocab_size=512, seq_len=64, global_batch=2, seed=0,
         with_enc_frames=True, d_model=32, enc_seq_ratio=1.5),
    dict(vocab_size=51_865, seq_len=6, global_batch=3, seed=3)])
def test_dataset_equals_the_reference_bit_for_bit(kw):
    ours, theirs = SyntheticLMDataset(**kw), JaxDataset(**kw)
    for step in (0, 1, 12):
        got, want = ours.batch_np(step), theirs.batch_np(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        batch = ours.batch(step, device="cpu")
        for k in want:
            np.testing.assert_array_equal(batch[k].numpy(), want[k])
    # stateless, step-addressed, next-token targets
    b1 = ours.batch_np(12)
    np.testing.assert_array_equal(
        b1["tokens"], SyntheticLMDataset(**kw).batch_np(12)["tokens"])
    assert not np.array_equal(b1["tokens"], ours.batch_np(13)["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
