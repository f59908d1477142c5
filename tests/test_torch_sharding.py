"""The port's logical-axis sharding (``repro_torch.dist.sharding``) against
the JAX package's ``repro.dist.sharding``, which imports ``jax.sharding``
and so is not one of the port's verbatim copies: ``logical_to_spec`` on
the reference's own seeded fuzz, ``default_rules`` for every config, mesh
stand-in and step kind, every config's parameter and cache axes, and the
reference's unit cases. Single process, no process group."""
import random

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import test_sharding as ref_cases
from repro.configs import get_config as jax_config
from repro.configs.base import ARCH_IDS
from repro.dist import sharding as ref
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.dist.sharding import (default_rules, logical_to_spec,
                                       placements)
from repro_torch.models import Model
from repro_torch.models.common import flatten_tree
from repro_torch.models.transformer import model_specs

torch.set_num_threads(1)


def stand_in(**sizes):
    """A mesh stand-in: axis names in order and their sizes, the only
    things the rules read."""
    class M:
        axis_names = tuple(sizes)
        shape = dict(sizes)
    return M()


MESHES = {"16x16": stand_in(data=16, model=16),
          "2x16x16": stand_in(pod=2, data=16, model=16),
          "2x4": stand_in(data=2, model=4),
          "1x8": stand_in(data=1, model=8)}
KINDS = ("train", "prefill", "decode", "decode_long")


def _port_invariants(axes, rules, shape, mesh):
    spec = logical_to_spec(axes, rules, shape=shape, mesh=mesh)
    assert len(spec) == len(axes)
    seen = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        group = list(entry) if isinstance(entry, tuple) else [entry]
        prod = 1
        for a in group:
            assert a in mesh.axis_names
            seen.append(a)
            prod *= mesh.shape[a]
        assert dim % prod == 0, (axes, rules, shape, spec)
    assert len(seen) == len(set(seen)), (axes, rules, shape, spec)
    return spec


def test_logical_to_spec_equals_reference_on_its_fuzz():
    """The reference's 500-case seeded sweep (``random.Random(0)``, its
    ``_rand_case``): the port's spec equals the reference's
    ``PartitionSpec`` entry for entry, with the shape and without, and
    keeps the reference's invariants."""
    rng = random.Random(0)
    for _ in range(500):
        axes, rules, shape, mesh = ref_cases._rand_case(rng)
        ref_cases._check_invariants(axes, rules, shape, mesh)
        got = _port_invariants(axes, rules, shape, mesh)
        assert got == tuple(ref.logical_to_spec(axes, rules, shape=shape,
                                                mesh=mesh))
        assert logical_to_spec(axes, rules) == \
            tuple(ref.logical_to_spec(axes, rules))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_rules_equal_reference(arch, mesh_name, kind):
    mesh = MESHES[mesh_name]
    got = default_rules(get_config(arch), mesh, kind)
    want = ref.default_rules(jax_config(arch), mesh, kind)
    assert got.pop("__mesh__") is mesh and want.pop("__mesh__") is mesh
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_axes_equal_reference(arch):
    """Every leaf of the full-width spec tree: the same shape and logical
    axes (``layers`` prepended to the stacked ones), and the cache's
    axes (the port's model built on the meta device)."""
    want = flatten_tree(JaxModel(jax_config(arch)).specs())
    got = model_specs(get_config(arch))
    assert set(got) == set(want)
    for name, spec in got.items():
        assert (spec.shape, spec.axes) == (want[name].shape,
                                           want[name].axes), name
    model = Model(get_config(arch, smoke=True), device="meta")
    assert model.cache_logical_axes() == \
        JaxModel(jax_config(arch, smoke=True)).cache_logical_axes()


def test_placements_of_the_rules_tuples():
    """One placement a mesh axis: ``Shard(d)`` where dim d names it (a
    tuple split major to minor in mesh order), else ``Replicate()``; a
    size-1 axis splits nothing; a tuple out of mesh order is refused."""
    mesh = MESHES["2x16x16"]
    assert placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements((None, ("data", "model")), mesh) == \
        (Replicate(), Shard(1), Shard(1))
    assert placements((None, None), mesh) == (Replicate(),) * 3
    assert placements(("model", "data"), MESHES["1x8"]) == \
        (Replicate(), Shard(0))
    with pytest.raises(ValueError, match="mesh order"):
        placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="mesh order"):
        placements((("model", "data"),), MESHES["16x16"])
    # the rules' own tuples are in mesh order for every config and kind
    for arch in ARCH_IDS:
        for kind in KINDS:
            rules = default_rules(get_config(arch), mesh, kind)
            cache = Model(get_config(arch, smoke=True), device="meta")
            for axes in cache.cache_logical_axes().values():
                placements(logical_to_spec(axes, rules), mesh)
            placements(logical_to_spec(("act_batch", "act_seq"), rules),
                       mesh)


class TestLogicalToSpec:
    """The reference's ``TestLogicalToSpec`` on the port (its host mesh
    of one device is a (1, 1) stand-in)."""

    @pytest.fixture
    def mesh(self):
        return stand_in(data=1, model=1)

    def test_basic_mapping(self, mesh):
        rules = {"a": "data", "b": "model", "__mesh__": mesh}
        assert logical_to_spec(("a", "b", None), rules) == \
            ("data", "model", None)

    def test_duplicate_axis_dropped(self, mesh):
        rules = {"a": "data", "b": "data"}
        assert logical_to_spec(("a", "b"), rules) == ("data", None)

    def test_non_divisible_dropped(self, mesh):
        rules = {"a": "data"}
        assert logical_to_spec(("a",), rules, shape=(7,), mesh=mesh) == \
            ("data",)
        assert logical_to_spec(("a",), rules, shape=(7,),
                               mesh=stand_in(data=2)) == (None,)

    def test_tuple_axes(self, mesh):
        rules = {"a": ("data", "model")}
        assert logical_to_spec(("a", None), rules) == \
            (("data", "model"), None)

    def test_special_keys_are_not_axes(self, mesh):
        rules = {"__attn_head_pad__": "model", "a": "model"}
        assert logical_to_spec(("__attn_head_pad__", "a"), rules) == \
            (None, "model")


class TestDefaultRules:
    """The reference's ``TestDefaultRules`` on the port."""

    def test_kv_seq_fallback_for_small_kv(self):
        r = default_rules(get_config("glm4-9b"), MESHES["16x16"], "decode")
        assert r["cache_kv_heads"] is None and r["cache_seq"] == "model"

    def test_kv_heads_sharded_when_divisible(self):
        r = default_rules(get_config("stablelm-3b"), MESHES["16x16"],
                          "decode")
        assert r["cache_kv_heads"] == "model"

    def test_fsdp_only_in_train(self):
        cfg = get_config("glm4-9b")
        assert default_rules(cfg, MESHES["16x16"], "train")["embed"] == \
            ("data",)
        assert default_rules(cfg, MESHES["16x16"], "decode")["embed"] is None

    def test_moe_rules(self):
        small = default_rules(get_config("moonshot-v1-16b-a3b"),
                              MESHES["16x16"])
        assert small["experts"] == "model"
        big = default_rules(get_config("qwen3-moe-235b-a22b"),
                            MESHES["16x16"])
        assert big["experts"] == "model" and big["moe_mlp"] == ("data",)

    def test_long_decode_rules(self):
        r = default_rules(get_config("rwkv6-3b"), MESHES["16x16"],
                          "decode_long")
        assert r["act_batch"] is None

    def test_head_padding_only_when_heads_do_not_divide(self):
        cfg = get_config("qwen2-1.5b")                 # H 12
        assert default_rules(cfg, MESHES["16x16"])["__attn_head_pad__"] \
            == 16
        assert default_rules(cfg, stand_in(data=4, model=4))[
            "__attn_head_pad__"] == 0
        assert default_rules(cfg, stand_in(data=1, model=1))[
            "__attn_head_pad__"] == 0


@pytest.mark.parametrize("G,KV,width,want", [
    (6, 2, 16, 8),        # qwen2-1.5b on 16: the reference's 16 heads
    (3, 2, 4, 4),         # qwen2 smoke on 4: 8 heads, 2 a rank
    (3, 2, 8, 4),         # on 8: one head a rank
    (5, 8, 16, 6),        # 48 heads, 3 a rank, G' = 6
    (4, 4, 16, 4),        # divides already
])
def test_padded_group_keeps_whole_groups(G, KV, width, want):
    from repro_torch.models.attention import padded_group
    Gp = padded_group(G, KV, width)
    assert Gp == want and KV * Gp % width == 0
    local = KV * Gp // width
    assert Gp % local == 0 or local % Gp == 0
