"""The port's sharding rules and elastic grid against the JAX package's.

For every config, at 16x16 ``("data", "model")`` and 2x16x16 ``("pod",
"data", "model")``, every leaf of the parameter, optimizer and cache
trees gets the spec the reference's rules give the same path: the
reference's ``param_shardings`` / ``opt_state_shardings`` /
``cache_shardings`` run on a JAX ``AbstractMesh`` (no devices), the
port's on a stand-in whose ``.shape`` is the axis-size dict, over the
port's own trees (full size, on fake tensors).  ``largest_grid`` is held
to the reference's cases (``tests/test_runtime_integration.py``).
"""
import dataclasses
import types

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch import sharding as jsharding
from repro.models import lm as jlm
from repro.optim import AdamW as JAdamW
from repro_torch import configs
from repro_torch.launch import sharding
from repro_torch.models import lm
from repro_torch.optim import AdamW
from repro_torch.runtime import elastic

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHES = [(128, 1024), (1, 1024)]


def _standin(sizes, names):
    return types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                 mesh_dim_names=names)


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))


def _ref_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(_key(k) for k in path): tuple(sh.spec)
            for path, sh in leaves}


def _port_specs(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_specs(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(v.spec)
    return out


@pytest.fixture(scope="module")
def trees():
    """{arch: (reference shapes, port fake trees)} at full size."""
    out = {}
    for arch in configs.ARCH_NAMES:
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        jp = jax.eval_shape(lambda: jlm.init_model(jcfg,
                                                   jax.random.PRNGKey(0)))
        jo = jax.eval_shape(JAdamW(lr_fn=lambda s: 1e-3).init, jp)
        with FakeTensorMode():
            tp = lm.init_model(cfg, seed=0, device="cpu")
            to = AdamW(lr_fn=lambda s: 1e-3).init(tp)
        out[arch] = (jp, jo, tp, to)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_and_optimizer_specs_match_the_reference(trees, arch, mesh):
    sizes, names = MESHES[mesh]
    jmesh, standin = AbstractMesh(sizes, names), _standin(sizes, names)
    jp, jo, tp, to = trees[arch]
    want = _ref_specs(jsharding.param_shardings(jp, jmesh))
    got = _port_specs(sharding.param_shardings(tp, standin))
    assert got == want
    want = _ref_specs(jsharding.opt_state_shardings(jo, jmesh))
    got = _port_specs(sharding.opt_state_shardings(to, standin))
    assert got == want


@pytest.mark.parametrize("batch,max_len", CACHES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_cache_specs_match_the_reference(arch, mesh, batch, max_len):
    sizes, names = MESHES[mesh]
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    enc = max_len if cfg.is_encoder_decoder else None
    jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch, max_len,
                                               jcfg.act_dtype, enc_len=enc))
    tc = lm.init_cache(cfg, batch, max_len, cfg.act_dtype, "meta",
                       enc_len=enc)
    want = _ref_specs(jsharding.cache_shardings(jc, AbstractMesh(sizes,
                                                                 names)))
    got = _port_specs(sharding.cache_shardings(tc, _standin(sizes, names)))
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_logits_specs_match_the_reference(mesh):
    sizes, names = MESHES[mesh]
    cfg = configs.get("whisper-tiny")
    batch = {k: v for k, v in configs.input_specs(
        cfg, configs.SHAPES["train_4k"]).items()}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), "int32")
              for k, v in batch.items()}
    jmesh, standin = AbstractMesh(sizes, names), _standin(sizes, names)
    assert _port_specs(sharding.batch_shardings(batch, standin)) == \
        _ref_specs(jsharding.batch_shardings(jbatch, jmesh))
    assert tuple(sharding.logits_sharding(standin).spec) == \
        tuple(jsharding.logits_sharding(jmesh).spec)


def test_input_specs_and_counts_match_the_reference():
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import input_specs as jinput_specs
    assert list(configs.SHAPES) == list(JSHAPES)
    for arch in configs.ARCH_NAMES:
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        for name, shape in configs.SHAPES.items():
            assert dataclasses.asdict(shape) == dataclasses.asdict(
                JSHAPES[name])
            got = configs.input_specs(cfg, shape)
            want = jinput_specs(jcfg, JSHAPES[name])
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""),
                        v.device.type) for k, v in got.items()} == {
                k: (tuple(v.shape), str(v.dtype), "meta")
                for k, v in want.items()}
            assert configs.cell_skipped(arch, name) == \
                jconfigs.cell_skipped(arch, name)
    assert sorted(configs.all_cells(include_skipped=True)) == sorted(
        jconfigs.all_cells(include_skipped=True))


def test_elastic_largest_grid():
    assert elastic.largest_grid(256, 16, (16, 8, 4, 2, 1)) == (16, 16)
    assert elastic.largest_grid(240, 16, (16, 8, 4, 2, 1)) == (15, 16)
    assert elastic.largest_grid(7, 16, (16, 8, 4, 2, 1)) == (7, 1)
    assert elastic.largest_grid(12, 16, (16, 8, 4, 2, 1)) == (3, 4)
    assert elastic.largest_grid(1, 16, (16, 8, 4, 2, 1)) == (1, 1)


def test_elastic_largest_grid_tie_breaking():
    assert elastic.largest_grid(8, 16, (8, 4, 2, 1)) == (1, 8)
    assert elastic.largest_grid(6, 4, (4, 2, 1)) == (3, 2)
    assert elastic.largest_grid(4, 2, (2, 1)) == (2, 2)
    assert elastic.largest_grid(5, 16, (16, 8, 4, 2)) == (5, 1)


def test_elastic_degenerate_survivor_counts():
    for n in (0, -3):
        with pytest.raises(ValueError):
            elastic.largest_grid(n, 16, (16, 8, 4, 2, 1))
    with pytest.raises(ValueError):
        elastic.plan_remesh([], params_shape=None)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    standin = _standin((2, 16, 16), ("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), "model"), standin) == (
        Shard(0), Shard(0), Shard(1))
    assert sharding.placements((None, None), standin) == (Replicate(),) * 3
    assert sharding.local_shape((64, 4096), (("pod", "data"), "model"),
                                standin) == (2, 256)
