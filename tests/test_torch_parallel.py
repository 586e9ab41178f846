"""The port's mesh and sharding rules (``ray_tpu_torch.parallel``) against
the reference's (``ray_tpu.parallel``).

Placements: for every leaf of the nano, GPT-2-small and a nano MoE
config, under ``LM_RULES``, ``PP_LM_RULES`` and ``DP_RULES``, on five
meshes, the port's ``tree_shardings`` prints the reference's
``PartitionSpec`` at the same pytree path (the reference on the
conftest's 8 virtual CPU devices), and ``make_train_step``'s parameter
placements equal the reference's ``state_sh["params"]``. ``shard_tree``
cuts each rank's slice as the reference's ``device_put`` lays its
``addressable_shards``. ``MeshConfig.resolve`` agrees, errors included.
On four CPU rank processes (gloo, one pool for the module) the mesh's
coordinates and groups and a placement's gather and reduce equal numpy.

JAX is imported inside the tests: the rank processes import this module
to find their functions and need only torch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import tree as ttree
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tshr
from torch_threads import one_torch_thread  # noqa: F401

MESHES = [{"fsdp": 8}, {"fsdp": 4, "tp": 2}, {"dp": 2, "fsdp": 2, "tp": 2},
          {"tp": 4}, {"dp": 8}]
RULES = ["LM_RULES", "PP_LM_RULES", "DP_RULES"]
CONFIGS = ["nano", "small", "moe"]


def _ids(m):
    return "-".join(f"{k}{v}" for k, v in m.items())


def _configs(name):
    from ray_tpu.models import gpt as jgpt

    if name == "moe":
        return (dataclasses.replace(jgpt.CONFIGS["nano"], n_experts=4),
                dataclasses.replace(tgpt.CONFIGS["nano"], n_experts=4))
    return jgpt.CONFIGS[name], tgpt.CONFIGS[name]


def _ref_mesh(axes):
    import jax

    from ray_tpu.parallel import create_mesh

    n = int(np.prod(list(axes.values())))
    return create_mesh(axes, devices=jax.devices()[:n])


def _ref_specs(shardings):
    import jax

    from ray_tpu.parallel.sharding import path_str

    return {path_str(p): str(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(shardings)[0]}


def _port_specs(placements):
    return {ttree.path_str(p): str(pl.spec)
            for p, pl in ttree.leaves_with_paths(placements)}


def _meta_tree(tcfg):
    return tgpt.params_tree({n: torch.empty(s, device="meta") for n, s in
                             tgpt.param_shapes(tcfg).items()})


@pytest.mark.parametrize("axes", MESHES, ids=_ids)
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("config", CONFIGS)
def test_tree_shardings_match_reference(config, rules, axes):
    import jax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import sharding as jshr

    jcfg, tcfg = _configs(config)
    abstract = jax.eval_shape(lambda k: jgpt.init_params(k, jcfg),
                              jax.random.PRNGKey(0))
    want = _ref_specs(jshr.tree_shardings(abstract, _ref_mesh(axes),
                                          getattr(jshr, rules)))
    got = _port_specs(tshr.tree_shardings(_meta_tree(tcfg), axes,
                                          getattr(tshr, rules)))
    assert got == want


def test_param_paths_are_the_reference_tree():
    """The name -> path map gives the reference's pytree exactly, and
    ``params_flat`` inverts ``params_tree``."""
    import jax

    from ray_tpu.models import gpt as jgpt

    for name in CONFIGS[::2]:
        jcfg, tcfg = _configs(name)
        ref = jax.eval_shape(lambda k: jgpt.init_params(k, jcfg),
                              jax.random.PRNGKey(0))
        want = {p: tuple(x.shape) for p, x in _ref_leaves(ref)}
        tree = _meta_tree(tcfg)
        assert {ttree.path_str(p): tuple(x.shape)
                for p, x in ttree.leaves_with_paths(tree)} == want
        flat = tgpt.params_flat(tree)
        assert set(flat) == set(tgpt.param_shapes(tcfg))


def _ref_leaves(tree):
    import jax

    from ray_tpu.parallel.sharding import path_str

    return [(path_str(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("axes", MESHES[:3], ids=_ids)
def test_train_step_placements_match_reference(axes):
    """``make_train_step``'s parameter placements equal the reference's
    ``state_sh["params"]`` (the default ``LM_RULES``); the moments follow
    their parameters, as the reference's ``mu``/``nu`` do."""
    from ray_tpu.models import gpt as jgpt

    jcfg, tcfg = _configs("small")
    _, _, state_sh, batch_sh = jgpt.make_train_step(jcfg, _ref_mesh(axes))
    mesh = tmesh.Mesh(tshr._sizes(axes), range(8), 0, "cpu")
    _, _, places, batch = tgpt.make_train_step(tcfg, mesh)
    want = _ref_specs(state_sh["params"])
    assert _port_specs(tgpt.params_tree(places["params"])) == want
    assert places["opt"] is places["params"]
    assert str(places["step"].spec) == str(state_sh["step"].spec)
    assert str(batch.spec) == str(batch_sh.spec)


@pytest.mark.parametrize("axes", MESHES, ids=_ids)
@pytest.mark.parametrize("seq", [None, "sp"])
def test_batch_sharding_matches_reference(axes, seq):
    from ray_tpu.parallel import sharding as jshr

    want = jshr.batch_sharding(_ref_mesh(axes), extra_seq_axis=seq).spec
    assert str(tshr.batch_sharding(axes, extra_seq_axis=seq).spec) == \
        str(want)


@pytest.mark.parametrize("axes", MESHES, ids=_ids)
def test_shard_tree_matches_reference_shards(axes):
    """Rank r's shard of every nano leaf (and a [V, d] embedding) is what
    the reference's ``device_put`` puts on device r."""
    import jax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import sharding as jshr

    jcfg, tcfg = _configs("nano")
    jmesh = _ref_mesh(axes)
    jparams = jgpt.init_params(jax.random.PRNGKey(3), jcfg)
    jsh = jshr.tree_shardings(jparams, jmesh, jshr.LM_RULES)
    placed = jshr.shard_tree(jparams, jsh)
    mesh = tmesh.Mesh(tshr._sizes(axes), range(jmesh.size), 0, "cpu")
    tree = tgpt.params_tree(tgpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    places = tshr.tree_shardings(tree, mesh, tshr.LM_RULES)
    devices = list(jmesh.devices.flat)
    for (path, arr), (_, leaf), (_, pl) in zip(
            _ref_leaves(placed), ttree.leaves_with_paths(tree),
            ttree.leaves_with_paths(places)):
        for shard in arr.addressable_shards:
            r = devices.index(shard.device)
            np.testing.assert_array_equal(pl.shard(leaf, rank=r).numpy(),
                                          np.asarray(shard.data),
                                          err_msg=f"{path} rank {r}")


@pytest.mark.parametrize("axes,n", [
    ({}, 8), ({"dp": -1}, 8), ({"dp": 2, "tp": -1}, 8), ({"fsdp": 4}, 4),
    ({"tp": 2, "fsdp": 2, "dp": 2}, 8), ({"dp": -1, "tp": -1}, 8),
    ({"dp": 3, "tp": -1}, 8), ({"dp": 2, "tp": 2}, 8)],
    ids=lambda x: str(x))
def test_mesh_config_resolve_matches_reference(axes, n):
    from ray_tpu.parallel import MeshConfig as JMeshConfig

    def run(cls):
        try:
            return cls(dict(axes)).resolve(n)
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(tmesh.MeshConfig) == run(JMeshConfig)


def test_single_process_mesh():
    """Without a process group a mesh is this process alone; axes are
    laid out in AXIS_ORDER; a mesh of several ranks needs a group."""
    m = tmesh.create_mesh({"tp": 1, "dp": 1}, device="cpu")
    assert m.axis_names == ("dp", "tp") and m.size == 1 and m.rank == 0
    assert tmesh.mesh_shape(m) == {"dp": 1, "tp": 1}
    one = tmesh.single_device_mesh(device="cpu")
    assert one.shape == {"dp": 1} and one.device == torch.device("cpu")
    with pytest.raises(ValueError, match="use 2 devices, have 1"):
        tmesh.create_mesh({"dp": 2}, device="cpu")
    with pytest.raises(ValueError):
        tmesh.create_mesh({"dp": 1}, ranks=[1], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.create_mesh({"dp": 1})


def test_mesh_coordinates_are_row_major():
    """Rank r sits where ``np.arange(n).reshape(dims)`` puts r, as the
    reference lays out ``jax.devices()``; ``axis_ranks`` lists the
    ranks along an axis."""
    m = tmesh.Mesh({"dp": 2, "fsdp": 2, "tp": 2}, range(8), 0, "cpu")
    grid = np.arange(8).reshape(2, 2, 2)
    for r in range(8):
        c = m.coords(r)
        assert grid[c["dp"], c["fsdp"], c["tp"]] == r
        assert m.index(("dp", "fsdp"), r) == 2 * c["dp"] + c["fsdp"]
    assert m.axis_ranks(("tp",), 5) == [4, 5]
    assert m.axis_ranks(("dp", "tp"), 5) == [0, 1, 4, 5]
    assert m.size_of(("fsdp", "sp")) == 2


def test_partition_spec_prints_as_jax():
    from jax.sharding import PartitionSpec as JP

    for parts in [(), ("fsdp", "tp"), (("dp", "fsdp"), None), (("fsdp",),),
                  (None, "tp")]:
        assert str(tshr.P(*parts)) == str(JP(*parts))
        assert tuple(tshr.P(*parts)) == tuple(JP(*parts))


# ------------------------------------------------ four CPU rank processes
@pytest.fixture(scope="module")
def pool4():
    from ray_tpu_torch._private.ranks import RankPool

    with RankPool(4, devices=("cpu",) * 4) as pool:
        yield pool


def _rank_placements():
    """On each rank: the mesh's coordinate and group ranks, and a
    placement's shard, gather and reduce of rank-dependent tensors."""
    import torch.distributed as dist

    m = tmesh.create_mesh({"dp": 2, "tp": 2}, device="cpu")
    r = dist.get_rank()
    full = torch.arange(48, dtype=torch.float32).reshape(4, 6, 2)
    out = {"coords": m.coords(), "tp": list(m.group("tp").ranks),
           "dp": list(m.group("dp").ranks),
           "all": list(m.group(("tp", "dp")).ranks)}
    for spec in [(), ("dp",), ("dp", "tp"), (None, "tp"), (("dp", "tp"),)]:
        pl = tshr.Placement(m, tshr.P(*spec))
        local = pl.shard(full)
        out[str(spec)] = (pl.gather(local).numpy(),
                          pl.reduce(full * (r + 1)).numpy(),
                          local.numpy())
    return out


def test_placements_on_four_ranks(pool4):
    res = pool4.run(_rank_placements)
    full = np.arange(48, dtype=np.float32).reshape(4, 6, 2)
    total = full * (1 + 2 + 3 + 4)
    m = tmesh.Mesh({"dp": 2, "tp": 2}, range(4), 0, "cpu")
    for r, out in enumerate(res):
        assert out["coords"] == m.coords(r)
        assert out["tp"] == m.axis_ranks(("tp",), r)
        assert out["dp"] == m.axis_ranks(("dp",), r)
        assert out["all"] == [0, 1, 2, 3]
        for spec in [(), ("dp",), ("dp", "tp"), (None, "tp"),
                     (("dp", "tp"),)]:
            pl = tshr.Placement(m, tshr.P(*spec))
            gathered, reduced, local = out[str(spec)]
            np.testing.assert_array_equal(gathered, full)
            want = pl.shard(torch.from_numpy(total), rank=r).numpy()
            np.testing.assert_array_equal(reduced, want)
            np.testing.assert_array_equal(
                local, pl.shard(torch.from_numpy(full), rank=r).numpy())
